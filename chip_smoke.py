"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build every CUDA kernel of the port from ``ops/csrc`` (one nvcc each,
   started together) and report the build time;
2. hold each kernel against its plain PyTorch version on the card at its
   path's shapes, in f32 and bf16, and time kernel, plain version, the
   PyTorch library call (a yardstick only) and the bound: ``fused_mha`` at
   the ViT-B/32 path's tile chunks (T = 50) and at ViT-L/14's T = 257 and
   577, and (checked, not timed) at B = 1 on every ragged edge of its
   64-row and 64-key tiles up to its 2048-token bound; ``cam_accumulate``
   at the ViT-B/32 and ViT-L/14 shapes of the multi-tail gradcam;
   ``channel_moments`` and its backward kernel at the 11 (C, S) shapes of
   the full-size UNet's GroupNorms, at B = 4 (OVSSC) and B = 8 (VOOL) (the
   backward bit for bit). Times are device times: the calls captured in a
   CUDA graph and replayed, so that the host's launch rate does not set
   them;
3. run small ``ClipSaliency`` pipelines on the card and on the CPU with the
   same weights and jitter draws, and the maps must agree: a single-tail
   one at T = 50 and a multi-tail one (4 blocks, num_layers=0, patch 14)
   whose head and tail run both relevancy kernels at T = 257; then two
   train steps of a small SemAbs3D on the card and on the CPU from the
   same weights and batch (f32, TF32 off); loss, grad norm, logits and the
   updated parameters must agree;
4. run the relevancy path at full width: the ``image`` command's
   ``build_saliency`` + ``relevancy`` (ViT-B/32, random weights, bf16,
   "ours" crops on a seeded 480x640 image, the 9 headline labels), one
   warm-up image, then timed images;
5. profile one more image with ``torch.profiler`` (device time by kernel);
6. the multi-tail path at full width: OpenAI ViT-L/14's shape (24 blocks
   of width 1024, patch 14, T = 257) with random weights, bf16, the CLI's
   num_layers=10 (13 tail blocks, each accumulated by ``cam_accumulate``)
   on the same image and labels: one warm-up image, timed images, and one
   profiled image;
7. run the OVSSC train step at full width: ``SemAbs3DConfig()`` (128^3
   voxels, 16 channels, f_maps 16, 6 levels, 4 patches), bf16, random
   weights from seed 0, the ``bench_train.py`` batch from numpy seed 0
   (80,000 input points, 4 x 400,000 query points); first the bf16 eval
   and train step against the same in f32 from the same weights, then one
   warm-up step, timed steps and one eval step;
8. profile one more train step, with the device time of the moments
   backward (the autograd node ``_ChannelMomentsBackward``);
9. the five nets of ``FORWARD_LOSS`` at a small size (16^3 voxels, 8
   channels, 3 levels, 2 descriptions or patches), card vs CPU from one
   init, f32 with TF32 off: the forward-loss and one train step of each,
   two steps and an eval step of SemAbsVOOL;
10. the VOOL train step at full width: ``SemAbsVOOLConfig()`` (two
   saliency streams of 4 descriptions through one UNet pass over 8
   stacked 128^3 volumes, spatial sampler, cosine relation pointer), bf16,
   random weights from seed 0, the ``scripts/profile_vool_step.py`` batch
   from numpy seed 0; bf16 against f32, one warm-up step, timed steps, an
   eval step and the 25-cutoff point and 32^3 voxel metrics over its
   logits;
11. profile one more VOOL train step, likewise.

Each path's kernel launch counts are set to 0 just before its timed run
and read just after. Prints a ``{"kernels": [...]}`` line, the card's name
and power limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core and f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HEADLINE_LABELS = [
    "basketball jersey", "nintendo switch", "television", "ping pong table",
    "vase", "fireplace", "abstract painting of a vespa", "carpet", "wall",
]
TIMED_IMAGES = 3
TIMED_VITL_IMAGES = 2
TIMED_STEPS = 5
# OpenAI ViT-L/14, the published shape (the JAX package reads it from a
# state dict with config_from_state_dict; no preset in either package)
VIT_L_14 = dict(embed_dim=768, image_resolution=224, vision_layers=24,
                vision_width=1024, vision_patch_size=14, context_length=77,
                vocab_size=49408, text_width=768, text_heads=12, text_layers=12)
# fused_mha's ragged token counts, checked at B = 1
RAGGED_TOKENS = (1, 16, 17, 50, 63, 64, 65, 197, 256, 257, 577, 2048)
# (C, S) of every GroupNorm of the full-size UNet, at B = 4 volumes (OVSSC)
# and B = 8 (VOOL's one pass over both streams' 4 volumes; the kernel plans
# its launch from B * C rows, so (8, 32, 64^3) and (8, 512, 4^3) give row
# counts that no B = 4 shape gives)
UNET_GN_SHAPES = [(16, 128**3), (16, 64**3), (32, 64**3), (32, 32**3),
                  (64, 32**3), (64, 16**3), (128, 16**3), (128, 8**3),
                  (256, 8**3), (256, 4**3), (512, 4**3)]
MOMENTS_SHAPES = [(b, c, s) for b in (4, 8) for c, s in UNET_GN_SHAPES]
# the small nets of the card-vs-CPU phases
SMALL_UNET = dict(voxel_shape=(16, 16, 16), unet_num_channels=8, unet_f_maps=4,
                  unet_num_groups=2, unet_num_levels=3, pts_feat_extractor_hidden_dim=16)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100) -> float:
    """Mean device time of one ``fn`` call: ``iters`` calls captured in a
    CUDA graph, the graph replayed 3 times between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def mha_bound(b: int, t: int, w: int, heads: int, dtype: str):
    """(least ms, "bytes" or "operations") for fused MHA: q, k, v read once
    and out written once at the HBM rate, or 4*B*H*T*T*hd flops at the
    dtype's peak, whichever is larger."""
    elt = 2 if dtype == "bfloat16" else 4
    bytes_s = 4 * b * t * w * elt / HBM_BYTES_PER_S
    flops_s = 4 * b * heads * t * t * (w // heads) / PEAK_FLOPS[dtype]
    return 1e3 * max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def phase_kernel(card: str):
    """fused_mha vs mha_reference at the relevancy paths' shapes."""
    import torch
    import torch.nn.functional as F

    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha, mha_reference

    # (B, T, W): ViT-B/32 tile chunks of the main path at tile_batch_size 32
    # ("ours" at 480x640: 12, 45, 42, 48 rows) and the batches 32, 64, 90;
    # a ViT-L/14 chunk at 224 px (T = 257) and at 336 px (T = 577)
    shapes = [(b, 50, 768) for b in (12, 32, 42, 45, 48, 64, 90)]
    shapes += [(48, 257, 1024), (48, 577, 1024)]
    # f32: sums in another order than cuBLAS; bf16: the output and the probs
    # round to bf16 (1 ulp = 2^-8 relative), so 2 ulp of |out| <= 2
    tols = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        atol, rtol = tols[dname]
        for b, t, w in shapes:
            heads = w // 64
            qkv = torch.randn(b, t, 3 * w, device="cuda", generator=g).to(dtype)
            q, k, v = qkv.split(w, dim=-1)  # strided views, as on the path
            out = fused_mha(q, k, v, heads)
            ref = mha_reference(q, k, v, heads)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
            if not ok:
                raise AssertionError(f"fused_mha {dname} B={b} T={t}: max err {err}")
            qh, kh, vh = (a.reshape(b, t, heads, w // heads).transpose(1, 2)
                          for a in (q, k, v))
            iters = 100 if t <= 64 else 20
            row = dict(dtype=dname, B=b, T=t, W=w, max_abs_err=err, max_rel_err=rel,
                       ms=time_ms(lambda: fused_mha(q, k, v, heads), iters),
                       plain_ms=time_ms(lambda: mha_reference(q, k, v, heads), iters),
                       library_ms=time_ms(
                           lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
                       )
            row["bound_ms"], row["bound_by"] = mha_bound(b, t, w, heads, dname)
            rows.append(row)
            print(f"[kernel] fused_mha {json.dumps(row)} card={card}", flush=True)
            del qkv, q, k, v, qh, kh, vh, out, ref
        # every ragged edge of the 64-row query and 64-key K/V tiles, one
        # token, the first version's 256-token bound and the 2048-token bound
        for t in RAGGED_TOKENS:
            q, k, v = torch.randn(1, t, 3 * 768, device="cuda", generator=g).to(dtype).split(768, -1)
            out, ref = fused_mha(q, k, v, 12).float(), mha_reference(q, k, v, 12).float()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, atol=atol, rtol=rtol):
                raise AssertionError(f"fused_mha {dname} B=1 T={t}: max err {err}")
            print(f"[kernel] fused_mha {dname} B=1 T={t} max_abs_err {err} card={card}",
                  flush=True)
            del q, k, v, out, ref
    return rows


def cam_bound(l: int, b: int, h: int, t: int, dtype: str):
    """(least ms, "bytes" or "operations") for one cam_accumulate step:
    grad and attn read once, R read once and out written once (f32) at the
    HBM rate, or the flops at the f32 peak: 2*L*B*T^3 for the product and
    3 an element of grad (product, ReLU, head sum)."""
    elt = 2 if dtype == "bfloat16" else 4
    bytes_s = ((l * b * h + b * h) * t * t * elt + 2 * l * b * t * t * 4) / HBM_BYTES_PER_S
    flops_s = (2 * l * b * t**3 + 3 * l * b * h * t * t) / PEAK_FLOPS["float32"]
    return 1e3 * max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def cam_inputs(g, l, b, h, t, dtype, identity=False):
    """Attention probabilities, signed gradients and R (the identity
    expanded with stride 0, as the gradcam's first step, or dense)."""
    import torch

    attn = torch.softmax(4 * torch.randn(b, h, t, t, device="cuda", generator=g), -1)
    grad = 0.05 * torch.randn(l, b, h, t, t, device="cuda", generator=g)
    eye = torch.eye(t, device="cuda")
    r = (eye.expand(l, b, t, t) if identity else
         eye + 0.1 * torch.rand(l, b, t, t, device="cuda", generator=g))
    return grad.to(dtype), attn.to(dtype), r


def cam_rel_err(out, grad, attn, r, positive):
    """(largest |kernel - plain| over the sum of its terms' magnitudes,
    |R| + |cam| @ |R|, largest |kernel - plain|): both versions sum the same
    f32 values in other orders."""
    import torch

    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate_reference

    ref = cam_accumulate_reference(grad, attn, r, positive)
    scale = r.abs() + torch.matmul(
        (grad.float() * attn[None].float()).abs().mean(dim=2), r.abs())
    return ((out - ref).abs() / scale).max().item(), (out - ref).abs().max().item()


def phase_cam(card: str):
    """cam_accumulate vs cam_accumulate_reference at the multi-tail
    gradcam's shapes: L = 9 labels, B = 48 tiles, ViT-B/32 (H = 12, T = 50)
    and ViT-L/14 (H = 16, T = 257), a dense R, ReLU on (timed) and off, and
    the stride-0 identity R. Tolerance: 1e-5 of |R| + |cam| @ |R|."""
    import torch

    from semantic_abstraction_tpu_torch.ops.cam_accumulate import (
        cam_accumulate, cam_accumulate_reference)

    l, b = 9, 48
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for h, t in ((12, 50), (16, 257)):
            errs = []
            for positive, identity in ((True, False), (False, False), (True, True)):
                grad, attn, r = cam_inputs(g, l, b, h, t, dtype, identity)
                out = cam_accumulate(grad, attn, r, positive)
                torch.cuda.synchronize()
                errs.append(cam_rel_err(out, grad, attn, r, positive))
                if not errs[-1][0] <= 1e-5:
                    raise AssertionError(f"cam_accumulate {dname} T={t} relu={positive} "
                                         f"identity={identity}: rel err {errs[-1][0]}")
                del out
            # timed: the general step (dense R), ReLU on, as on the path
            grad, attn, r = cam_inputs(g, l, b, h, t, dtype)
            iters = 100 if t <= 64 else 20
            row = dict(dtype=dname, L=l, B=b, H=h, T=t,
                       max_rel_err=max(e[0] for e in errs),
                       max_abs_err=max(e[1] for e in errs),
                       ms=time_ms(lambda: cam_accumulate(grad, attn, r), iters),
                       plain_ms=time_ms(lambda: cam_accumulate_reference(grad, attn, r),
                                        iters),
                       library_ms=None)
            row["bound_ms"], row["bound_by"] = cam_bound(l, b, h, t, dname)
            rows.append(row)
            print(f"[kernel] cam_accumulate {json.dumps(row)} tol rel 1e-5 card={card}",
                  flush=True)
            del grad, attn, r
            torch.cuda.empty_cache()
    return rows


def moments_bound(b: int, c: int, s: int, dtype: str):
    """(least ms, "bytes" or "operations") for the channel moments: x read
    once and the two (B, C) f32 outputs written once at the HBM rate, or
    3 flops an element (an add and a fused multiply-add) at the f32 peak."""
    elt = 2 if dtype == "bfloat16" else 4
    bytes_s = (b * c * s * elt + 8 * b * c) / HBM_BYTES_PER_S
    flops_s = 3 * b * c * s / PEAK_FLOPS["float32"]
    return 1e3 * max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def moments_backward_bound(b: int, c: int, s: int, dtype: str):
    """(least ms, "bytes" or "operations") for the moments' backward: x
    read once, gx written once and the two (B, C) f32 gradients read once
    at the HBM rate, or 3 flops an element (two products and a sum) at the
    f32 peak."""
    elt = 2 if dtype == "bfloat16" else 4
    bytes_s = (2 * b * c * s * elt + 8 * b * c) / HBM_BYTES_PER_S
    flops_s = 3 * b * c * s / PEAK_FLOPS["float32"]
    return 1e3 * max(bytes_s, flops_s), ("bytes" if bytes_s >= flops_s else "operations")


def phase_moments(card: str):
    """channel_moments vs channel_moments_reference at the UNet's shapes,
    and its backward kernel vs channel_moments_backward_reference.
    Tolerance: the same f32 values summed in another order, so s2 (terms
    >= 0) within rtol 1e-5 and s1 within 1e-5 of sum |x| (it cancels); the
    backward bit for bit. Returns (forward rows, backward rows)."""
    import torch

    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward, channel_moments_backward_reference,
        channel_moments_reference)

    rows, brows = [], []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, s in MOMENTS_SHAPES:
            x = (torch.randn(b, c, s, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            s1, s2 = channel_moments(x)
            r1, r2 = channel_moments_reference(x)
            torch.cuda.synchronize()
            d1, d2 = (s1 - r1).abs(), (s2 - r2).abs()
            ok = bool((d1 <= 1e-5 * x.float().abs().sum(-1) + 1e-6).all()
                      and (d2 <= 1e-5 * r2 + 1e-6).all())
            err = max(d1.max().item(), d2.max().item())
            rel = max((d1 / x.float().abs().sum(-1).clamp_min(1e-30)).max().item(),
                      (d2 / r2.clamp_min(1e-30)).max().item())
            if not ok:
                raise AssertionError(f"channel_moments {dname} C={c} S={s}: max "
                                     f"err {err} (relative {rel})")
            row = dict(dtype=dname, B=b, C=c, S=s, max_abs_err=err, max_rel_err=rel,
                       ms=time_ms(lambda: channel_moments(x)),
                       plain_ms=time_ms(lambda: channel_moments_reference(x)),
                       library_ms=time_ms(
                           lambda: torch.var_mean(x, dim=2, correction=0)))
            row["bound_ms"], row["bound_by"] = moments_bound(b, c, s, dname)
            rows.append(row)
            print(f"[kernel] channel_moments {json.dumps(row)} tol rel 1e-5 "
                  f"card={card}", flush=True)
            g1 = torch.randn(b, c, device="cuda", generator=g)
            g2 = torch.randn(b, c, device="cuda", generator=g) / s
            gx = channel_moments_backward(x, g1, g2)
            ref = channel_moments_backward_reference(x, g1, g2)
            torch.cuda.synchronize()
            err = (gx.float() - ref.float()).abs().max().item()
            if not torch.equal(gx, ref):
                raise AssertionError(f"channel_moments backward {dname} B={b} C={c} S={s}: "
                                     f"not bit-equal to the plain version, max err {err}")
            iters = 20 if b * c * s >= 2**24 else 100
            # the library call: addcmul computes g1 + 2 x g2 in f32 and
            # rounds once into gx's dtype, one elementwise pass
            lib_out = torch.empty_like(x)
            brow = dict(dtype=dname, B=b, C=c, S=s, max_abs_err=err,
                        ms=time_ms(lambda: channel_moments_backward(x, g1, g2), iters),
                        plain_ms=time_ms(
                            lambda: channel_moments_backward_reference(x, g1, g2), iters),
                        library_ms=time_ms(lambda: torch.addcmul(
                            g1[..., None], x, g2[..., None], value=2.0, out=lib_out), iters))
            brow["bound_ms"], brow["bound_by"] = moments_backward_bound(b, c, s, dname)
            brows.append(brow)
            print(f"[kernel] channel_moments_backward {json.dumps(brow)} bit-equal "
                  f"card={card}", flush=True)
            del x, s1, s2, r1, r2, gx, ref, lib_out
            torch.cuda.empty_cache()
    return rows, brows


def small_config(**kw):
    from semantic_abstraction_tpu_torch.clip import ClipConfig

    spec = dict(embed_dim=32, image_resolution=224, vision_layers=3,
                vision_width=128, vision_patch_size=32, context_length=77,
                vocab_size=49408, text_width=64, text_heads=2, text_layers=1)
    return ClipConfig(**{**spec, **kw})


def phase_small(card: str, label: str, cfg, num_layers: int, kernels):
    """Small ClipSaliency, card vs CPU: same weights, same jitter draws, f32
    at full precision (TF32 off). The card run must launch every kernel in
    ``kernels`` (wrapper functions with a ``launches`` count)."""
    import torch

    from semantic_abstraction_tpu_torch.clip import (
        ClipSaliency, CropSpec, SaliencyConfig, init_clip_params)

    config = SaliencyConfig(crops=(CropSpec(64, 16), CropSpec(32, 8)),
                            horizontal_flipping=True, augmentations=1)
    img = np.random.RandomState(3).randint(0, 255, (64, 96, 3), dtype=np.uint8)
    maps = {}
    for dev in ("cpu", "cuda"):
        sal = ClipSaliency(init_clip_params(0, cfg, device=dev), cfg,
                           tile_batch_size=8, num_layers=num_layers)
        for k in kernels:
            k.launches = 0
        m, _ = sal.get_clip_saliency(img, ["chair", "table", "sofa"],
                                     ["a photo of a {}"], config,
                                     generator=torch.Generator().manual_seed(1))
        maps[dev] = m.float().cpu()
    launches = {k.__name__: k.launches for k in kernels}
    diff = (maps["cuda"] - maps["cpu"]).abs().max().item()
    scale = maps["cpu"].abs().max().item()
    # f16 maps of f32 pipelines that differ in summation order: allow 4 f16
    # ulp of the largest value
    tol = 2.0**-8 * scale
    print(f"[{label}] card vs cpu max|diff| {diff} (tol {tol}, max|map| {scale}) "
          f"card launches {launches} card={card}", flush=True)
    if not (scale > 0 and diff <= tol and torch.isfinite(maps["cuda"]).all()):
        raise AssertionError(f"{label}: card and CPU disagree ({diff} > {tol})")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: a kernel was not launched: {launches}")
    return diff


def ovssc_batch(rs, b, p, n, m, device):
    """The bench_train.py batch layout: uniform points over (and past) the
    scene bounds, one saliency feature a point, 0/1 labels, no masks."""
    import torch

    batch = {
        "input_xyz_pts": rs.uniform(-1, 1.9, (b, n, 3)).astype(np.float32),
        "input_feature_pts": rs.randn(b, p, n, 1).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1, 1.9, (b, p, m, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (b, p, m)).astype(np.float32),
        "out_of_bounds_pts": np.zeros((b, p, m), bool),
        "out_of_frustum_pts_mask": np.zeros((b, p, m), bool),
        "padding_mask": np.zeros((b, p), bool),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def phase_small_ovssc(card: str):
    """A small SemAbs3D (16^3 voxels, 8 channels, 3 levels), card vs CPU:
    the port's own init drawn once on the CPU and copied to both, the same
    batch, f32 with TF32 off, two train steps and an eval step.
    Tolerances: loss and grad norm rtol 1e-4 at each step; logits and the
    updated parameters rtol 1e-4, atol 1e-5 (f32 sums in other orders:
    cuDNN's convolutions, the scatter's and the sampler backward's
    atomics on the card)."""
    import copy

    import torch

    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_eval_step, make_optimizer, make_train_step,
        ovssc_forward_loss)

    cfg = SemAbs3DConfig(voxel_shape=(16, 16, 16), unet_num_channels=8,
                         unet_f_maps=4, unet_num_groups=2, unet_num_levels=3,
                         pts_feat_extractor_hidden_dim=16)
    model = init_net(0, cfg, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        tx = make_optimizer(lr=1e-2, num_warmup_steps=1, num_training_steps=50)
        state = init_train_state(copy.deepcopy(model).to(dev), tx)
        step = make_train_step(ovssc_forward_loss, cfg, tx, compute_dtype=torch.float32)
        batch = ovssc_batch(np.random.RandomState(6), 1, 2, 512, 1024, dev)
        stats = []
        for _ in range(2):
            state, st = step(state, batch)
            stats.append({k: float(v) for k, v in st.items()})
        aux = make_eval_step(ovssc_forward_loss, cfg, compute_dtype=torch.float32)(
            state.model, batch)
        runs[dev] = (stats, aux["logits"].cpu(),
                     {k: v.detach().cpu() for k, v in state.model.named_parameters()})
    (cs, cl, cp), (gs, gl, gp) = runs["cpu"], runs["cuda"]
    for i, (a, b) in enumerate(zip(cs, gs)):
        for k in ("loss", "grad_norm"):
            if not abs(a[k] - b[k]) <= 1e-4 * abs(a[k]):
                raise AssertionError(f"small ovssc step {i + 1} {k}: cpu {a[k]} "
                                     f"card {b[k]}")
    logit_err = (gl - cl).abs().max().item()
    torch.testing.assert_close(gl, cl, rtol=1e-4, atol=1e-5)
    param_err = max((gp[k] - cp[k]).abs().max().item() for k in cp)
    for k in cp:
        torch.testing.assert_close(gp[k], cp[k], rtol=1e-4, atol=1e-5, msg=k)
    print(f"[small-ovssc] card vs cpu: steps {gs} vs {cs}; max|logit diff| "
          f"{logit_err}; max|param diff| {param_err} card={card}", flush=True)


def phase_bf16_vs_f32(card: str, label: str, forward_loss, cfg, model, batch,
                      loss_rtol: float = 1e-4):
    """A full-width path in bf16 against the same path in f32 on the card,
    from the same weights and batch (TF32 off): the eval step's loss and
    logits, and one train step's loss, accuracy and grad norm, each dtype
    on its own copy of the model. Tolerances: logits mean |diff| <= 2^-6
    mean |f32| (4 bf16 ulps) and max |diff| <= 2^-4 max |f32|; loss
    ``loss_rtol`` (OVSSC 1e-4; VOOL 1e-3: its logits are cosines / 0.07,
    14x the rounding of OVSSC-scale logits, and its bf16 loss read 4.3e-4
    to 4.5e-4 apart from f32 on the H100); accuracy atol 2e-3 (points near 0 flip);
    grad norm rtol 1e-1.
    The grad norm's bound is loose because bf16's gradients at this size
    differ from f32's by about a tenth of their norm as a vector (printed
    here); that the bf16 path is the reference's is held on the CPU,
    against the JAX package's bf16 step, in ``tests/test_torch_ovssc.py``
    and ``tests/test_torch_vool.py``."""
    import copy

    import torch

    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_eval_step, make_optimizer, make_train_step)
    from semantic_abstraction_tpu_torch.runtime.train import global_norm

    res = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = copy.deepcopy(model)
        aux = make_eval_step(forward_loss, cfg, compute_dtype=dtype)(m, batch)
        tx = make_optimizer(num_training_steps=1000)
        _, stats = make_train_step(forward_loss, cfg, tx, compute_dtype=dtype)(
            init_train_state(m, tx), batch)
        # the step leaves its gradients in .grad (unclipped below norm 2);
        # a parameter the forward does not read has none
        res[name] = (aux["logits"].float(), aux["loss"].item(),
                     {k: v.item() for k, v in stats.items()},
                     [p.grad.float() for p in m.parameters() if p.grad is not None])
        del m, aux, tx
        torch.cuda.empty_cache()
    (bl, bloss, bst, bg), (fl, floss, fst, fg) = res["bf16"], res["f32"]
    diff, ref = (bl - fl).abs(), fl.abs()
    mean_rel = (diff.mean() / ref.mean()).item()
    max_rel = (diff.max() / ref.max()).item()
    grad_rel = (global_norm([b - f for b, f in zip(bg, fg)]) / global_norm(fg)).item()
    print(f"[{label}] bf16 vs f32 at full width: logits mean|diff|/mean|f32| "
          f"{mean_rel} max|diff|/max|f32| {max_rel}; eval loss {bloss} vs {floss}; "
          f"train step {bst} vs {fst}; |g_bf16 - g_f32| / |g_f32| {grad_rel} "
          f"card={card}", flush=True)
    loss_tol = loss_rtol * abs(floss)
    print(f"[{label}] loss rtol {loss_rtol}: |bf16 - f32| / |f32| eval "
          f"{abs(bloss - floss) / abs(floss)} step "
          f"{abs(bst['loss'] - fst['loss']) / abs(fst['loss'])}", flush=True)
    checks = [mean_rel <= 2.0**-6, max_rel <= 2.0**-4,
              abs(bloss - floss) <= loss_tol,
              abs(bst["loss"] - fst["loss"]) <= loss_tol,
              abs(bst["accuracy"] - fst["accuracy"]) <= 2e-3,
              abs(bst["grad_norm"] - fst["grad_norm"]) <= 1e-1 * abs(fst["grad_norm"])]
    if not all(checks):
        raise AssertionError(f"{label}: full-width bf16 disagrees with f32: checks {checks}")


def phase_ovssc(card: str):
    """The OVSSC train step at full width through the runtime's entry
    points (bench_train.py's workload)."""
    import torch

    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_eval_step, make_optimizer, make_train_step,
        ovssc_forward_loss)

    cfg = SemAbs3DConfig()
    t0 = time.perf_counter()
    tx = make_optimizer(num_training_steps=1000)
    state = init_train_state(init_net(0, cfg), tx)
    step = make_train_step(ovssc_forward_loss, cfg, tx, compute_dtype=torch.bfloat16)
    batch = ovssc_batch(np.random.RandomState(0), 1, 4, 80000, 400000, "cuda")
    torch.cuda.synchronize()
    print(f"[ovssc] weights and batch built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_bf16_vs_f32(card, "ovssc-bf16", ovssc_forward_loss, cfg, state.model, batch)

    t0 = time.perf_counter()
    state, stats = step(state, batch)
    torch.cuda.synchronize()
    print(f"[ovssc] warm-up step {time.perf_counter() - t0:.3f} s loss "
          f"{stats['loss'].item()}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fused_mha.launches = channel_moments.launches = channel_moments_backward.launches = 0
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"fused_mha": fused_mha.launches,
                "channel_moments": channel_moments.launches,
                "channel_moments_backward": channel_moments_backward.launches}
    loss, grad_norm = stats["loss"].item(), stats["grad_norm"].item()
    peak = torch.cuda.max_memory_allocated() / 1e9

    if not (np.isfinite(loss) and np.isfinite(grad_norm) and grad_norm > 0):
        raise AssertionError(f"ovssc step: loss {loss} grad_norm {grad_norm}")
    if launches["channel_moments"] <= 0 or launches["channel_moments_backward"] <= 0:
        raise AssertionError(f"the OVSSC path left a moments kernel unlaunched: {launches}")
    eval_step = make_eval_step(ovssc_forward_loss, cfg, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    aux = eval_step(state.model, batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if aux["logits"].shape != (1, 4, 400000) or not torch.isfinite(aux["logits"]).all():
        raise AssertionError(f"eval logits {tuple(aux['logits'].shape)} not finite")
    print(f"[ovssc] step seconds {times} steps/s {TIMED_STEPS / sum(times)} "
          f"loss {loss} accuracy {stats['accuracy'].item()} grad_norm {grad_norm} "
          f"peak mem GB {peak:.2f} launches {launches} channel_moments per step "
          f"{launches['channel_moments'] / TIMED_STEPS} backward per step "
          f"{launches['channel_moments_backward'] / TIMED_STEPS} eval step {eval_s:.3f} s "
          f"(loss {aux['loss'].item()}) card={card}", flush=True)
    return state, step, batch, launches, sum(times) / len(times)


def small_net_configs():
    """The five nets of ``FORWARD_LOSS`` at SMALL_UNET's size."""
    from semantic_abstraction_tpu_torch.models import (
        ClipSpatialVOOLConfig, SemAbs3DConfig, SemAbsVOOLConfig,
        SemanticAwareOVSSCConfig, SemanticAwareVOOLConfig)

    def unet(**kw):
        return SemAbs3DConfig(**SMALL_UNET, **kw)

    return {
        "ovssc/semantic_abstraction": unet(),
        "ovssc/semantic_aware": SemanticAwareOVSSCConfig(
            completion=unet(network_inputs=("rgb",), output_dim=32), clip_hidden_dim=32),
        "vool/semantic_abstraction": SemAbsVOOLConfig(
            completion=unet(decoder_concat_xyz_pts=False), pointing_dim=16),
        "vool/semantic_aware": SemanticAwareVOOLConfig(
            completion=unet(network_inputs=("rgb",), output_dim=16,
                            decoder_concat_xyz_pts=False),
            pointing_dim=16, clip_hidden_dim=32),
        "vool/clip_spatial": ClipSpatialVOOLConfig(
            completion=unet(decoder_concat_xyz_pts=False)),
    }


def net_batch(key: str, rs, d: int, n: int, m: int, device, embed: int = 32):
    """A batch of one scene for the forward-loss ``key``: points over and
    past the scene bounds, 10% of the query points out of bounds, a
    padded description, relation ids over the whole table."""
    import torch

    task, approach = key.split("/")
    batch = {
        "input_xyz_pts": rs.uniform(-1, 1.9, (1, n, 3)).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1.2, 2.1, (1, d, m, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (1, d, m)).astype(np.float32),
        "out_of_bounds_pts": rs.rand(1, d, m) < 0.1,
        "padding_mask": np.arange(d)[None] == d - 1,
    }
    feats = {"semantic_abstraction": 1, "semantic_aware": 3, "clip_spatial": 1}[approach]
    if task == "ovssc":
        batch["input_feature_pts"] = rs.randn(1, d, n, feats).astype(np.float32)
        batch["out_of_frustum_pts_mask"] = rs.rand(1, d, m) < 0.05
        if approach == "semantic_aware":
            batch["semantic_class_features"] = rs.randn(1, d, embed).astype(np.float32)
    else:
        batch["spatial_relation_id"] = rs.randint(0, 7, (1, d))
        names = {"semantic_abstraction": ("input_target_saliency_pts",
                                          "input_reference_saliency_pts"),
                 "semantic_aware": ("input_rgb_pts",),
                 "clip_spatial": ("input_description_saliency_pts",)}[approach]
        for name in names:
            batch[name] = rs.randn(1, d, n, feats).astype(np.float32)
        if approach == "semantic_aware":
            batch["target_obj_features"] = rs.randn(1, d, embed).astype(np.float32)
            batch["reference_obj_features"] = rs.randn(1, d, embed).astype(np.float32)
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def phase_small_nets(card: str):
    """The five ``FORWARD_LOSS`` entries at a small size, card vs CPU: one
    init per net (the port's, on the CPU) copied to both devices, the same
    batch (2 descriptions or patches, the second padded), f32 with TF32
    off. Each: the forward-loss and one train step; SemAbsVOOL: two train
    steps and an eval step. Tolerances as the small OVSSC phase: loss and
    grad norm rtol 1e-4 at each step; logits and every updated parameter
    (the VOOL nets' unread completion decoder included) rtol 1e-4, atol
    1e-5. The card runs must launch channel_moments."""
    import copy

    import torch

    from semantic_abstraction_tpu_torch.models import init_net
    from semantic_abstraction_tpu_torch.ops.channel_moments import channel_moments
    from semantic_abstraction_tpu_torch.runtime import (
        FORWARD_LOSS, init_train_state, make_eval_step, make_optimizer, make_train_step)

    for key, cfg in small_net_configs().items():
        forward_loss = FORWARD_LOSS[key]
        model = init_net(0, cfg, device="cpu")
        steps = 2 if key == "vool/semantic_abstraction" else 1
        runs = {}
        for dev in ("cpu", "cuda"):
            channel_moments.launches = 0
            batch = net_batch(key, np.random.RandomState(6), 2, 512, 1024, dev)
            with torch.no_grad():
                loss, aux = forward_loss(copy.deepcopy(model).to(dev), cfg, batch, False,
                                         torch.float32)
            logits = aux["logits"]
            tx = make_optimizer(lr=1e-2, num_warmup_steps=1, num_training_steps=50)
            state = init_train_state(copy.deepcopy(model).to(dev), tx)
            step = make_train_step(forward_loss, cfg, tx, compute_dtype=torch.float32)
            stats = [{"forward_loss": loss.item()}]
            for _ in range(steps):
                state, st = step(state, batch)
                stats.append({k: v.item() for k, v in st.items()})
            if key == "vool/semantic_abstraction":
                logits = make_eval_step(forward_loss, cfg, compute_dtype=torch.float32)(
                    state.model, batch)["logits"]
            runs[dev] = (stats, logits.cpu(), channel_moments.launches,
                         {k: v.detach().cpu() for k, v in state.model.named_parameters()})
        (cs, cl, _, cp), (gs, gl, launches, gp) = runs["cpu"], runs["cuda"]
        for i, (a, b) in enumerate(zip(cs, gs)):
            for k in ("forward_loss", "loss", "grad_norm"):
                if k in a and not abs(a[k] - b[k]) <= 1e-4 * abs(a[k]):
                    raise AssertionError(f"small {key} step {i} {k}: cpu {a[k]} card {b[k]}")
        torch.testing.assert_close(gl, cl, rtol=1e-4, atol=1e-5)
        for k in cp:
            torch.testing.assert_close(gp[k], cp[k], rtol=1e-4, atol=1e-5, msg=k)
        if launches <= 0:
            raise AssertionError(f"small {key}: the card run launched no channel_moments")
        print(f"[small-nets] {key} card vs cpu: {gs} vs {cs}; max|logit diff| "
              f"{(gl - cl).abs().max().item()}; max|param diff| "
              f"{max((gp[k] - cp[k]).abs().max().item() for k in cp)} over {len(cp)} "
              f"tensors; channel_moments launches {launches} card={card}", flush=True)


def vool_batch(rs, device):
    """The scripts/profile_vool_step.py batch: 80,000 input points, target
    and reference saliency of 4 descriptions, 4 x 400,000 query points,
    0/1 labels, relation ids in 0..5, no masks."""
    import torch

    batch = {
        "input_xyz_pts": rs.uniform(-1, 1.9, (1, 80000, 3)).astype(np.float32),
        "input_target_saliency_pts": rs.randn(1, 4, 80000, 1).astype(np.float32),
        "input_reference_saliency_pts": rs.randn(1, 4, 80000, 1).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1, 1.9, (1, 4, 400000, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (1, 4, 400000)).astype(np.float32),
        "spatial_relation_id": rs.randint(0, 6, (1, 4)).astype(np.int32),
        "out_of_bounds_pts": np.zeros((1, 4, 400000), bool),
        "padding_mask": np.zeros((1, 4), bool),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def phase_vool(card: str):
    """The SemAbsVOOL train step at full width through the runtime's entry
    points, then its eval step and the eval loop's metric pass."""
    import torch

    from semantic_abstraction_tpu_torch.models import SemAbsVOOLConfig, init_net
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.runtime import (
        eval_cutoffs_for, init_train_state, make_eval_step, make_optimizer,
        make_train_step, point_and_voxel_stats, vool_forward_loss)

    cfg = SemAbsVOOLConfig()
    t0 = time.perf_counter()
    tx = make_optimizer(num_training_steps=1000)
    state = init_train_state(init_net(0, cfg), tx)
    step = make_train_step(vool_forward_loss, cfg, tx, compute_dtype=torch.bfloat16)
    batch = vool_batch(np.random.RandomState(0), "cuda")
    torch.cuda.synchronize()
    print(f"[vool] weights and batch built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)
    phase_bf16_vs_f32(card, "vool-bf16", vool_forward_loss, cfg, state.model, batch,
                      loss_rtol=1e-3)

    t0 = time.perf_counter()
    state, stats = step(state, batch)
    torch.cuda.synchronize()
    print(f"[vool] warm-up step {time.perf_counter() - t0:.3f} s loss "
          f"{stats['loss'].item()}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    channel_moments.launches = channel_moments_backward.launches = 0
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"channel_moments": channel_moments.launches,
                "channel_moments_backward": channel_moments_backward.launches}
    loss, grad_norm = stats["loss"].item(), stats["grad_norm"].item()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(loss) and np.isfinite(grad_norm) and grad_norm > 0):
        raise AssertionError(f"vool step: loss {loss} grad_norm {grad_norm}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"the VOOL path left a moments kernel unlaunched: {launches}")

    eval_step = make_eval_step(vool_forward_loss, cfg, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    aux = eval_step(state.model, batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    logits = aux["logits"]
    if logits.shape != (1, 4, 400000) or not torch.isfinite(logits).all():
        raise AssertionError(f"vool eval logits {tuple(logits.shape)} not finite")
    cutoffs = eval_cutoffs_for("vool", detailed=True)
    t0 = time.perf_counter()
    metrics = point_and_voxel_stats(logits, batch["output_label_pts"],
                                    batch["output_xyz_pts"], aux["ignore"], cutoffs,
                                    cfg.completion.scene_bounds, ((32, 32, 32),))
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - t0
    for k, v in metrics.items():
        if v.shape != (len(cutoffs), 1, 4) or not torch.isfinite(v[~v.isnan()]).all():
            raise AssertionError(f"vool metric {k}: {tuple(v.shape)} or not finite")
    best = metrics["voxel32x32x32_iou"].nanmean(dim=(1, 2))
    print(f"[vool] step seconds {times} steps/s {TIMED_STEPS / sum(times)} "
          f"loss {loss} accuracy {stats['accuracy'].item()} grad_norm {grad_norm} "
          f"peak mem GB {peak:.2f} launches {launches} channel_moments per step "
          f"{launches['channel_moments'] / TIMED_STEPS} backward per step "
          f"{launches['channel_moments_backward'] / TIMED_STEPS} eval step {eval_s:.3f} s "
          f"(loss {aux['loss'].item()}); {len(metrics)} metrics at {len(cutoffs)} "
          f"cutoffs in {metrics_s:.3f} s, voxel IoU by cutoff "
          f"{[round(v, 4) for v in best.tolist()]} card={card}", flush=True)
    return state, step, batch, launches, sum(times) / len(times)


def phase_main(card: str):
    """The image path at full width through the CLI's entry points."""
    import torch

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    args = cli.parser().parse_args(
        ["image", "--random-weights", "--labels", *HEADLINE_LABELS])
    t0 = time.perf_counter()
    sal = cli.build_saliency(args)
    print(f"[main] weights built in {time.perf_counter() - t0:.1f} s", flush=True)
    rs = np.random.RandomState(args.seed)
    img = rs.randint(0, 255, (480, 640, 3), dtype=np.uint8)

    t0 = time.perf_counter()
    maps = cli.relevancy(sal, img, args)
    torch.cuda.synchronize()
    print(f"[main] warm-up image {time.perf_counter() - t0:.3f} s", flush=True)

    fused_mha.launches = 0
    times = []
    for i in range(TIMED_IMAGES):
        args.seed = i + 1
        t0 = time.perf_counter()
        maps = cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"fused_mha": fused_mha.launches}

    if maps.shape != (9, 480, 640) or maps.dtype != torch.float16:
        raise AssertionError(f"maps {tuple(maps.shape)} {maps.dtype}")
    if not torch.isfinite(maps).all() or not (maps != 0).any():
        raise AssertionError("maps are not finite or all zero")
    if launches["fused_mha"] <= 0:
        raise AssertionError("the main path launched no fused_mha kernel")
    maps_per_s = 9 * TIMED_IMAGES / sum(times)
    print(f"[main] image seconds {times} maps/s {maps_per_s} launches "
          f"{launches} per image {launches['fused_mha'] / TIMED_IMAGES} "
          f"peak mem GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"card={card}", flush=True)
    return sal, img, args, launches, sum(times) / len(times)


def phase_vitl(card: str):
    """The multi-tail path at full width: ViT-L/14 (random weights from
    seed 0) behind the extractor the CLI builds, through ``relevancy``."""
    import warnings

    import torch

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.clip import (
        ClipConfig, ClipSaliency, init_clip_params)
    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    args = cli.parser().parse_args(
        ["image", "--random-weights", "--labels", *HEADLINE_LABELS])
    cfg = ClipConfig(**VIT_L_14)
    t0 = time.perf_counter()
    # what build_saliency does with a --clip-ckpt of this shape
    sal = ClipSaliency(init_clip_params(0, cfg, device="cuda"), cfg,
                       compute_dtype=torch.bfloat16,
                       tile_batch_size=args.tile_batch_size)
    torch.cuda.synchronize()
    print(f"[vitl14] weights built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in sal.model.parameters())} parameters, "
          f"{cfg.vision_layers - sal.num_layers - 1} tail blocks, T "
          f"{cfg.vision_tokens})", flush=True)
    img = np.random.RandomState(args.seed).randint(0, 255, (480, 640, 3), dtype=np.uint8)

    # a vmap fallback (a per-label loop inside the batched backward) warns
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        maps = cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
    msgs = sorted({str(w.message)[:160] for w in caught})
    print(f"[vitl14] warm-up image {time.perf_counter() - t0:.3f} s; "
          f"{len(caught)} warnings {msgs}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fused_mha.launches = cam_accumulate.launches = 0
    times = []
    for i in range(TIMED_VITL_IMAGES):
        args.seed = i + 1
        t0 = time.perf_counter()
        maps = cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"fused_mha": fused_mha.launches, "cam_accumulate": cam_accumulate.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9

    if maps.shape != (9, 480, 640) or maps.dtype != torch.float16:
        raise AssertionError(f"vitl14 maps {tuple(maps.shape)} {maps.dtype}")
    if not torch.isfinite(maps).all() or not (maps != 0).any():
        raise AssertionError("vitl14 maps are not finite or all zero")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"the ViT-L/14 path left a kernel unlaunched: {launches}")
    per_image = {k: n / TIMED_VITL_IMAGES for k, n in launches.items()}
    print(f"[vitl14] image seconds {times} seconds/image {sum(times) / len(times)} "
          f"maps/s {9 * TIMED_VITL_IMAGES / sum(times)} peak mem GB {peak:.2f} "
          f"launches {launches} per image {per_image} card={card}", flush=True)
    return sal, img, args, launches, sum(times) / len(times)


def phase_profile(card: str, label: str, run, unprofiled_s: float, port_kernels,
                  top: int = 12, nodes=()):
    """Device time by kernel over one ``run()`` (torch.profiler), and the
    share of the path's own kernels (device function names in
    ``port_kernels``) and of the autograd nodes named in ``nodes`` (every
    device kernel each launched). The busy share is given against the
    profiled wall and against ``unprofiled_s``, the mean unprofiled time of
    the same work (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device kernels only: a range such as Optimizer.step is also reported
    # on the device timeline, as a user annotation spanning its kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    attr = "self_device_time_total"
    total_us = sum(getattr(e, attr) for e in events)
    if total_us <= 0:
        print(f"[profile] {label}: device time not measured (no CUDA events) "
              f"card={card}")
        return
    busy = total_us / 1e6
    print(f"[profile] {label}: wall {wall:.3f} s (profiled), device busy "
          f"{busy:.3f} s = {100 * busy / wall:.1f}% of the profiled wall, "
          f"{100 * busy / unprofiled_s:.1f}% of the unprofiled time "
          f"{unprofiled_s:.3f} s; {sum(e.count for e in events)} device kernels "
          f"of {len(events)} names card={card}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:top]:
        us = getattr(e, attr)
        print(f"[profile]   {100 * us / total_us:5.1f}%  {us / 1e3:9.2f} ms  "
              f"x{e.count:<6d} {e.key[:90]}")
    for name in port_kernels:
        mine = [e for e in events if name in e.key]
        us = sum(getattr(e, attr) for e in mine)
        print(f"[profile]   port kernel {name}: {us / 1e3:.3f} ms in "
              f"{sum(e.count for e in mine)} launches = {100 * us / total_us:.2f}% "
              f"of device time")
    for name in nodes:
        # the node and the engine's evaluate_function around it: the
        # largest holds every kernel the node launched
        mine = [e for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CUDA and name in e.key]
        us = max((getattr(e, "device_time_total", 0.0) for e in mine), default=0.0)
        print(f"[profile]   autograd node {name}: {us / 1e3:.3f} ms of device time in "
              f"{max((e.count for e in mine), default=0)} calls = "
              f"{100 * us / total_us:.2f}% of device time")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # the port's package, from this checkout
    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card={card}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {list(_build.KERNELS)} built in "
          f"{time.perf_counter() - t0:.1f} s card={card}", flush=True)

    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    rows = phase_kernel(card)
    crows = phase_cam(card)
    mrows, brows = phase_moments(card)
    phase_small(card, "small", small_config(), 1, (fused_mha,))
    phase_small(card, "small-multitail", small_config(vision_layers=4, vision_patch_size=14),
                0, (fused_mha, cam_accumulate))
    phase_small_ovssc(card)
    sal, img, args, launches, image_s = phase_main(card)
    phase_profile(card, "relevancy image", lambda: cli.relevancy(sal, img, args),
                  image_s, ("fused_mha_",))
    del sal
    torch.cuda.empty_cache()
    sal, img, args, vitl_launches, vitl_s = phase_vitl(card)
    phase_profile(card, "vit-l/14 image", lambda: cli.relevancy(sal, img, args),
                  vitl_s, ("fused_mha_", "cam_accumulate_"), top=20)
    del sal
    torch.cuda.empty_cache()
    state, step, batch, ovssc_launches, step_s = phase_ovssc(card)
    phase_profile(card, "ovssc train step", lambda: step(state, batch), step_s,
                  ("moments_fwd", "moments_bwd"), nodes=("_ChannelMomentsBackward",))
    del state, step, batch
    torch.cuda.empty_cache()
    phase_small_nets(card)
    state, step, batch, vool_launches, vool_s = phase_vool(card)
    phase_profile(card, "vool train step", lambda: step(state, batch), vool_s,
                  ("moments_fwd", "moments_bwd"), top=16, nodes=("_ChannelMomentsBackward",))

    # the kernels line. fused_mha: bf16 at the ViT-B/32 path's dominant
    # chunk (48 rows, T = 50), errors over every bf16 shape of the two
    # relevancy paths (relative to max |out|), launches on the ViT-B/32
    # path; the same at the ViT-L/14 chunk (T = 257) under "vit_l14".
    # cam_accumulate: bf16 at the ViT-L/14 chunk (L = 9, B = 48, H = 16,
    # T = 257), errors over its bf16 shapes (relative to |R| + |cam| @ |R|,
    # tolerance 1e-5), launches on the ViT-L/14 path; no single PyTorch
    # call computes it. channel_moments: bf16 at level 0 (4, 16, 128^3),
    # errors over the 22 bf16 UNet shapes at B = 4 and 8 (relative to the
    # sum of |x| for s1 and to s2, tolerance 1e-5; the absolute error is one
    # of sums near 1e7); launches on the OVSSC path's timed steps, and under "vool" the
    # VOOL path's with the time at its level-0 shape (8, 16, 128^3). Its
    # "backward" entry: the backward kernel likewise (bit-equal to its plain
    # version, so max_abs_err 0; the library call is one torch.addcmul into
    # a tensor of x's dtype).
    def pick(rs, **kw):
        return next(r for r in rs if all(r[k] == v for k, v in kw.items()))

    def timing(r):
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    main = pick(rows, dtype="bfloat16", B=48, T=50)
    vitl = pick(rows, dtype="bfloat16", B=48, T=257)
    path_rows = [r for r in rows if r["dtype"] == "bfloat16"
                 and (r["B"], r["T"]) in ((12, 50), (42, 50), (45, 50), (48, 50), (48, 257))]
    cmain = pick(crows, dtype="bfloat16", T=257)
    cbf16 = [r for r in crows if r["dtype"] == "bfloat16"]
    mmain = pick(mrows, dtype="bfloat16", B=4, S=128**3)
    mvool = pick(mrows, dtype="bfloat16", B=8, S=128**3)
    mbf16 = [r for r in mrows if r["dtype"] == "bfloat16"]
    bmain = pick(brows, dtype="bfloat16", B=4, S=128**3)
    bvool = pick(brows, dtype="bfloat16", B=8, S=128**3)
    kernels = [{
        "name": "fused_mha", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/fused_mha.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:103",
        "launches": launches["fused_mha"],
        "max_abs_err": max(r["max_abs_err"] for r in path_rows),
        "max_rel_err": max(r["max_rel_err"] for r in path_rows),
        **timing(main),
        "vit_l14": {"launches": vitl_launches["fused_mha"], **timing(vitl)},
    }, {
        "name": "cam_accumulate", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/cam_accumulate.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:34",
        "launches": vitl_launches["cam_accumulate"],
        "max_abs_err": max(r["max_abs_err"] for r in cbf16),
        "max_rel_err": max(r["max_rel_err"] for r in cbf16),
        **timing(cmain),
    }, {
        "name": "channel_moments", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/channel_moments.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:239",
        "launches": ovssc_launches["channel_moments"],
        "max_abs_err": max(r["max_abs_err"] for r in mbf16),
        "max_rel_err": max(r["max_rel_err"] for r in mbf16),
        **timing(mmain),
        "vool": {"launches": vool_launches["channel_moments"], **timing(mvool)},
        "backward": {
            "name": "channel_moments_backward", "route": "cuda",
            "source": "semantic_abstraction_tpu_torch/ops/csrc/channel_moments.cu",
            "replaces": "semantic_abstraction_tpu/models/unet3d.py:75",
            "launches": ovssc_launches["channel_moments_backward"],
            "max_abs_err": max(r["max_abs_err"] for r in brows),
            **timing(bmain),
            "vool": {"launches": vool_launches["channel_moments_backward"],
                     **timing(bvool)},
        },
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
