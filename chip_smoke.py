"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

It does what no other tool of the repo does on the card. The kernels'
correctness cases are the card tests' (``tests/test_torch_*_card.py``);
the benchmark's cells (``benchmark/run.py``) time and trace the paths they
run: the ViT-B/32 and ViT-L/14 relevancy images and the OVSSC train step;
here those paths run untimed, for the checks and launch counts no cell
makes.
Phases (any failure ends the run with a non-zero exit and no result line;
each keeps the number that PERF.md and ROADMAP.md cite, so 5, 6, 8 and 11
are unused):

1. build every CUDA kernel of the port from ``ops/csrc`` (one nvcc each,
   started together) and report the build time;
2. time each kernel at its path's shapes beside its plain PyTorch version,
   the PyTorch library call (a yardstick only) and its roofline bound
   (``benchmark/counts.py`` and ``benchmark/counts_multitail.py``), in f32
   and bf16: ``fused_mha`` at the ViT-B/32 path's tile chunks (T = 50), at
   get_visual_feature's one image (B = 1, T = 50) and at ViT-L/14's T = 257
   and 577; ``cam_accumulate`` at the ViT-B/32 and ViT-L/14 shapes of the
   multi-tail gradcam; ``channel_moments`` and its backward kernel at the
   11 (C, S) shapes of the full-size UNet's GroupNorms, at B = 4 (OVSSC)
   and B = 8 (VOOL), the forward at B = 1 (the inference paths);
   ``lamb_update`` (the clip's norm and LAMB, replacing no Pallas kernel)
   at ``SemAbs3DConfig()``'s 121 leaves, its kernels at four chunk sizes
   and the host-clock ms of one clip + step beside the plain version's;
   ``tail_backward``'s LayerNorm and quick-GELU backward (replacing no
   Pallas kernel) at the ViT-L/14 cell's tile chunks of 12 and 105, beside
   a label's share of autograd's batched backward through the composite
   function and of the route's.
   Each timed shape is first read once against the plain version at the
   card test's tolerance, so that no wrong kernel is timed (``cam_accumulate``
   also with the stride-0 identity R of the gradcam's first step); and both
   moments kernels are checked, not timed, at a data-parallel rank's B = 2
   in f32, which no card test runs. Times are device times: the calls
   captured in a CUDA graph and replayed, so that the host's launch rate
   does not set them;
3. run small ``ClipSaliency`` pipelines on the card and on the CPU with the
   same weights and jitter draws, and the maps must agree: a single-tail
   one at T = 50 and a multi-tail one (4 blocks, num_layers=0, patch 14)
   whose head and tail run both relevancy kernels at T = 257; then two
   train steps of a small SemAbs3D on the card and on the CPU from the
   same weights and batch (f32, TF32 off); loss, grad norm, logits and the
   updated parameters must agree;
4. the relevancy paths at full width, untimed: the ``image`` command's
   ``build_saliency`` + ``relevancy`` (ViT-B/32, random weights, "ours"
   crops on a seeded 480x640 image, the 9 headline labels) on one image in
   bf16 and on the same image with ``--compute_dtype float32`` (K1's f32
   body, which no cell runs), then ViT-L/14 (random weights from seed 0,
   bf16, the general tail of 13 blocks at T = 257) on it: maps of the
   image's shape, finite and not all zero, as many K1 launches in f32 as in
   bf16, and on ViT-L/14 11 K1 and 13 K2 launches a gradcam call, and 25
   LayerNorm and 13 quick-GELU backward launches a label;
7. the OVSSC net at full width: ``SemAbs3DConfig()`` (128^3 voxels, 16
   channels, f_maps 16, 6 levels, 4 patches), random weights from seed 0,
   the ``bench_train.py`` batch from numpy seed 0 (80,000 input points, 4 x
   400,000 query points): the bf16 eval and train step against the same in
   f32 from the same weights, then a bf16 eval step;
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
12. the loop users run, for OVSSC and for VOOL at full width, through the
   port's ``runtime.experiment`` (``build_setup``, ``train``,
   ``eval_batches``): one epoch of 10 loader-fed steps (4 loader threads,
   the native loader kernels, pinned non-blocking copies) over in-memory
   full-width scenes (``MemoryScenes``: the card's machine has no h5py),
   then 2 eval batches at the 25 detailed cutoffs, then a ``latest.ckpt``
   round trip bit for bit; loader-fed steps/s (VOOL's beside the
   device-resident rate of phase 10), the share of the epoch spent waiting
   on the loader, H2D ms a batch, peak memory, the moments launches a step
   (33 forward and 33 backward) and the clip + LAMB launches a step (3);
13. the ``generate_relevancy dataset`` writer without h5py: 3 in-memory
   480x640 scenes whose labels (~40 each) come from ``_scene_labels`` over
   a THOR-like object list and descriptions, ViT-B/32 "ours" bf16, the maps
   cut to the 240x320 store on the card, through ``pipelined`` (pinned
   copies on a side stream, one scene deep) into an in-memory sink: seconds
   a scene, maps/s, the copies' bytes, ms and overlap, K1 launches a scene,
   peak memory; the sink's maps finite at the store shape, its features
   unit-norm with the mean row, and its last scene equal to a synchronous
   extraction;
14. TSDF fusion of a seeded 480x640 RGB-D frame at 240^3 on the card
   against the CPU (tsdf and weight within 1e-5, any other voxel at a
   rounding tie), and the host seconds of a dataset item's 128^3 ``tsdf``;
15. ``visualize ovssc-inference`` and ``vool-inference`` at full width on
   that frame through the CLI's commands (``SemAbs3DConfig()`` and
   ``SemAbsVOOLConfig()`` at random weights, bf16, 80,000 input points,
   the 240^3 sweep; 4 classes, 2 descriptions): the seconds of each stage
   (CLIP weights, relevancy, UNet, dense sweep, read-back, TSDF and
   carving, marching and export on the host), K1 launches, K3 launches (33
   a class, 66 a description) and peak memory;
16. data parallelism, world size 1: ``SemAbs3DConfig()`` at --batch_size 4,
   bf16, through ``experiment.train`` as phase 12 drives it, in a rank of a
   NCCL group (this script, started as torch.distributed.run starts a
   rank), the train step under DDP; then one process without a group from
   the same seed and items: the first 3 steps' loss and grad norm must
   agree; steps/s, K3 launches a step;
17. data parallelism, 2 ranks over gloo sharing the one card:
   ``SemAbs3DConfig()``, f32, 2 rows a rank of 2 patches whose halves keep
   different point counts (the masked mean over both ranks), 2 steps
   against one process at B = 4 from the same weights: loss, grad norm and
   every parameter; a rank that fails or times out fails the run;
18. an RN50-shaped ModifiedResNet CLIP from a seeded state dict in the
   reference layout (no checkpoint is in the repo): ``encode_image`` on the
   card against the CPU and images/s at B = 32; ``get_visual_feature`` on
   the seeded 480x640 image for ViT-B/32 (12 K1 launches a call) and RN50,
   card against CPU, ms a call.

THOR datagen (``datagen/``, ``cli/generate_thor_data.py``) does no device
work and ``ai2thor`` is not installed: it has no phase.

Each path's kernel launch counts are set to 0 just before its run and read
just after. Prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HEADLINE_LABELS = [
    "basketball jersey", "nintendo switch", "television", "ping pong table",
    "vase", "fireplace", "abstract painting of a vespa", "carpet", "wall",
]
TIMED_STEPS = 5
# OpenAI ViT-L/14, the published shape (the JAX package reads it from a
# state dict with config_from_state_dict; no preset in either package)
VIT_L_14 = dict(embed_dim=768, image_resolution=224, vision_layers=24,
                vision_width=1024, vision_patch_size=14, context_length=77,
                vocab_size=49408, text_width=768, text_heads=12, text_layers=12)
# (C, S) of every GroupNorm of the full-size UNet, at B = 4 volumes (OVSSC)
# and B = 8 (VOOL's one pass over both streams' 4 volumes; the kernel plans
# its launch from B * C rows, so (8, 32, 64^3) and (8, 512, 4^3) give row
# counts that no B = 4 shape gives)
UNET_GN_SHAPES = [(16, 128**3), (16, 64**3), (32, 64**3), (32, 32**3),
                  (64, 32**3), (64, 16**3), (128, 16**3), (128, 8**3),
                  (256, 8**3), (256, 4**3), (512, 4**3)]
MOMENTS_SHAPES = [(b, c, s) for b in (4, 8) for c, s in UNET_GN_SHAPES]
# and at B = 1, forward only: the inference paths' UNet under no_grad (one
# volume a class, or a description's target or reference)
MOMENTS_INFERENCE_SHAPES = [(1, c, s) for c, s in UNET_GN_SHAPES]
# a rank's rows of the 2-rank data-parallel OVSSC step (B = 2, f32):
# checked, forward and backward, not timed
MOMENTS_RANK_SHAPES = [(2, c, s) for c, s in UNET_GN_SHAPES]
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


def phase_kernel(card: str):
    """fused_mha timed against mha_reference at the relevancy paths'
    shapes, each shape read once against the plain version first."""
    import torch
    import torch.nn.functional as F

    from benchmark.counts import mha_bound_s
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha, mha_reference

    # (B, T, W): ViT-B/32 tile chunks of the main path at tile_batch_size 32
    # ("ours" at 480x640: 12, 45, 42, 48 rows) and the batches 32, 64, 90;
    # a ViT-L/14 chunk at 224 px (T = 257) and at 336 px (T = 577)
    # and get_visual_feature's one image (B = 1, T = 50)
    shapes = [(b, 50, 768) for b in (1, 12, 32, 42, 45, 48, 64, 90)]
    shapes += [(48, 257, 1024), (48, 577, 1024)]
    # the card test's: f32 sums in another order than cuBLAS; bf16: the
    # output and the probs round to bf16 (1 ulp = 2^-8 relative), so 2 ulp
    # of |out| <= 2
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
            if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
                raise AssertionError(f"fused_mha {dname} B={b} T={t}: max err {err}")
            qh, kh, vh = (a.reshape(b, t, heads, w // heads).transpose(1, 2)
                          for a in (q, k, v))
            iters = 100 if t <= 64 else 20
            row = dict(dtype=dname, B=b, T=t, W=w, max_abs_err=err, max_rel_err=rel,
                       ms=time_ms(lambda: fused_mha(q, k, v, heads), iters),
                       plain_ms=time_ms(lambda: mha_reference(q, k, v, heads), iters),
                       library_ms=time_ms(
                           lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
                       bound_ms=1e3 * mha_bound_s(b, t, w, heads, dname))
            rows.append(row)
            print(f"[kernel] fused_mha {json.dumps(row)} card={card}", flush=True)
            del qkv, q, k, v, qh, kh, vh, out, ref
    return rows


def cam_inputs(g, l, b, h, t, dtype, identity=False):
    """Attention probabilities, signed gradients and R: the identity
    expanded with stride 0, as at the gradcam's first step, or a dense R,
    as at a later one."""
    import torch

    attn = torch.softmax(4 * torch.randn(b, h, t, t, device="cuda", generator=g), -1)
    grad = 0.05 * torch.randn(l, b, h, t, t, device="cuda", generator=g)
    eye = torch.eye(t, device="cuda")
    r = (eye.expand(l, b, t, t) if identity else
         eye + 0.1 * torch.rand(l, b, t, t, device="cuda", generator=g))
    return grad.to(dtype), attn.to(dtype), r


def cam_rel_err(out, grad, attn, r):
    """(largest |kernel - plain| over the sum of its terms' magnitudes,
    |R| + |cam| @ |R|, largest |kernel - plain|), ReLU on: both versions sum
    the same f32 values in other orders."""
    import torch

    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate_reference

    ref = cam_accumulate_reference(grad, attn, r)
    scale = r.abs() + torch.matmul(
        (grad.float() * attn[None].float()).abs().mean(dim=2), r.abs())
    return ((out - ref).abs() / scale).max().item(), (out - ref).abs().max().item()


def phase_cam(card: str):
    """cam_accumulate timed against cam_accumulate_reference at the
    multi-tail gradcam's shapes: L = 9 labels, B = 48 tiles, ViT-B/32
    (H = 12, T = 50) and ViT-L/14 (H = 16, T = 257), a dense R, ReLU on, as
    on the path; each shape read once against the plain version first, to
    the card test's 1e-5 of |R| + |cam| @ |R|, with the stride-0 identity R
    of the path's first step (read, not timed) and with the dense R."""
    import torch

    from benchmark.counts_multitail import cam_bound_s
    from semantic_abstraction_tpu_torch.ops.cam_accumulate import (
        cam_accumulate, cam_accumulate_reference)

    l, b = 9, 48
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for h, t in ((12, 50), (16, 257)):
            for identity in (True, False):
                grad, attn, r = cam_inputs(g, l, b, h, t, dtype, identity)
                out = cam_accumulate(grad, attn, r)
                torch.cuda.synchronize()
                rel, err = cam_rel_err(out, grad, attn, r)
                if not rel <= 1e-5:
                    raise AssertionError(f"cam_accumulate {dname} T={t} "
                                         f"identity={identity}: rel err {rel}")
                del out
                if identity:
                    id_rel = rel
                    del grad, attn, r
            iters = 100 if t <= 64 else 20
            row = dict(dtype=dname, L=l, B=b, H=h, T=t, max_rel_err=rel, max_abs_err=err,
                       identity_max_rel_err=id_rel,
                       ms=time_ms(lambda: cam_accumulate(grad, attn, r), iters),
                       plain_ms=time_ms(lambda: cam_accumulate_reference(grad, attn, r),
                                        iters),
                       library_ms=None, bound_ms=1e3 * cam_bound_s(l, b, h, t, dname))
            rows.append(row)
            print(f"[kernel] cam_accumulate {json.dumps(row)} tol rel 1e-5 card={card}",
                  flush=True)
            del grad, attn, r
            torch.cuda.empty_cache()
    return rows


def phase_moments(card: str):
    """channel_moments timed against channel_moments_reference at the
    UNet's shapes, and its backward kernel against
    channel_moments_backward_reference, each shape read once against the
    plain version first; then both checked, not timed, at a rank's B = 2.
    Tolerance (the card test's): the same f32 values summed in another
    order, so s2 (terms >= 0) within rtol 1e-5 and s1 within 1e-5 of sum |x|
    (it cancels); the backward bit for bit. Returns (forward rows, backward
    rows)."""
    import torch

    from benchmark.counts import moments_backward_bound_s, moments_bound_s
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward, channel_moments_backward_reference,
        channel_moments_reference)

    rows, brows = [], []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, s in MOMENTS_SHAPES + MOMENTS_INFERENCE_SHAPES:
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
                           lambda: torch.var_mean(x, dim=2, correction=0)),
                       bound_ms=1e3 * moments_bound_s(b, c, s, dname))
            rows.append(row)
            print(f"[kernel] channel_moments {json.dumps(row)} tol rel 1e-5 "
                  f"card={card}", flush=True)
            if b == 1:  # the inference rows run forward only
                del x, s1, s2, r1, r2
                continue
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
                            g1[..., None], x, g2[..., None], value=2.0, out=lib_out), iters),
                        bound_ms=1e3 * moments_backward_bound_s(b, c, s, dname))
            brows.append(brow)
            print(f"[kernel] channel_moments_backward {json.dumps(brow)} bit-equal "
                  f"card={card}", flush=True)
            del x, s1, s2, r1, r2, gx, ref, lib_out
            torch.cuda.empty_cache()
    for b, c, s in MOMENTS_RANK_SHAPES:
        x = torch.randn(b, c, s, device="cuda", generator=g) * 2 + 0.5
        (s1, s2), (r1, r2) = channel_moments(x), channel_moments_reference(x)
        g1 = torch.randn(b, c, device="cuda", generator=g)
        g2 = torch.randn(b, c, device="cuda", generator=g) / s
        ok = bool(((s1 - r1).abs() <= 1e-5 * x.abs().sum(-1) + 1e-6).all()
                  and ((s2 - r2).abs() <= 1e-5 * r2 + 1e-6).all()
                  and torch.equal(channel_moments_backward(x, g1, g2),
                                  channel_moments_backward_reference(x, g1, g2)))
        if not ok:
            raise AssertionError(f"channel_moments float32 B={b} C={c} S={s} (a rank's "
                                 "rows) disagrees with its plain version")
        del x, s1, s2, r1, r2
    print(f"[kernel] channel_moments forward and backward float32 at the rank shapes "
          f"{MOMENTS_RANK_SHAPES[0][0]} x (C, S) of the UNet: within tolerance and bit-equal "
          f"card={card}", flush=True)
    return rows, brows


# chunk sizes timed beside lamb_update's default (ops/lamb_update.py CHUNK)
LAMB_CHUNKS = (1 << 14, 1 << 15, 1 << 16, 1 << 17)
LAMB_MAX_NORM = 2.0  # the recipe's clip; random unit gradients norm ~5,950


def lamb_bound_ms(numel: int) -> float:
    """Least ms of the clip + LAMB over ``numel`` float32 parameters, the
    clip engaged, each byte moved once at ``benchmark/counts.py``'s HBM
    rate: g read for the norm; g, m, v, p read and m, v, g written for the
    moments; m, v, p read and p written for the update (about 12 flops an
    element, far below the f32 peak)."""
    from benchmark.counts import HBM_BYTES_PER_S

    return 1e3 * 12 * 4 * numel / HBM_BYTES_PER_S


def phase_lamb(card: str):
    """``lamb_update``'s kernels (the clip's norm, the LAMB step) against
    its plain version at ``SemAbs3DConfig()``'s 121 leaves, random unit
    gradients (the clip engages): one step read against the plain version
    at the card test's tolerance (norm rtol 1e-5; p within 1e-5 of its
    leaf's change plus 4 ulps), 3 launches. Times: device ms of the kernels
    and of the plain version (CUDA graph replays; the norm fed to the update
    held at the first step's, so that each replay clips), the kernels at each of
    LAMB_CHUNKS, and the host-clock ms of one clip + step as the train step
    calls them, back to back, ending in a synchronise. Returns the row."""
    import torch

    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
    from semantic_abstraction_tpu_torch.models.lamb import Lamb
    from semantic_abstraction_tpu_torch.ops import lamb_update as lu

    params = list(init_net(0, SemAbs3DConfig()).parameters())
    numel = sum(p.numel() for p in params)
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = [torch.randn(p.shape, generator=g, device="cuda") for p in params]
    opt = Lamb(params, lr=1e-3, weight_decay=1e-5)
    hyper = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=1e-5,
                 clamp_weight_norm=10.0)
    start = [p.detach().clone() for p in params]
    ref_p = [p.clone() for p in start]
    ref_m = [torch.zeros_like(p) for p in params]
    ref_v = [torch.zeros_like(p) for p in params]
    for p, gr in zip(params, grads):
        p.grad = gr.clone()
    before = lu.global_grad_norm.launches + lu.lamb_update_.launches
    norm = opt.clip_grad_norm_(LAMB_MAX_NORM)
    opt.step()
    launches = lu.global_grad_norm.launches + lu.lamb_update_.launches - before
    ref_norm = lu.grad_norm_reference(grads)
    lu.lamb_update_reference(ref_p, grads, ref_m, ref_v, norm=ref_norm,
                             max_norm=LAMB_MAX_NORM, **hyper)
    torch.cuda.synchronize()
    norm_err = abs(norm.item() / ref_norm.item() - 1)
    p_share = max(((p.detach() - r).abs()
                   / (1e-5 * (r - r0).abs().max() + 4 * 2.0**-23 * r.abs() + 1e-30)).max().item()
                  for p, r, r0 in zip(params, ref_p, start))
    if launches != 3 or norm_err > 1e-5 or p_share > 1.0:
        raise AssertionError(f"lamb_update: launches {launches}, norm rel err {norm_err}, "
                             f"worst share of the p tolerance {p_share}")
    tensors = (params, [p.grad for p in params], [opt.state[p]["exp_avg"] for p in params],
               [opt.state[p]["exp_avg_sq"] for p in params], [(0, len(params))])
    held = lu.grad_norm_reference(tensors[1])

    def kernels(leaves):
        lu.global_grad_norm(leaves)
        lu.lamb_update_(leaves, 0, norm=held, max_norm=LAMB_MAX_NORM, **hyper)

    chunk_ms = {}
    for c in LAMB_CHUNKS:
        leaves = lu.Leaves(*tensors, chunk=c)
        chunk_ms[c] = time_ms(lambda: kernels(leaves), 20)

    def plain():
        lu.grad_norm_reference(tensors[1])
        lu.lamb_update_reference(*tensors[:4], norm=held, max_norm=LAMB_MAX_NORM, **hyper)

    plain_ms = time_ms(plain, 3)
    host_ms = {}
    for name, fn, n in (("kernel", lambda: (opt.clip_grad_norm_(LAMB_MAX_NORM), opt.step()), 20),
                        ("plain", plain, 5)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms[name] = 1e3 * (time.perf_counter() - t0) / n
    row = dict(leaves=len(params), params=numel, chunk=lu.CHUNK,
               max_rel_err=norm_err, p_tolerance_share=p_share, ms=chunk_ms[lu.CHUNK],
               plain_ms=plain_ms, library_ms=None, chunk_ms=chunk_ms,
               host_ms=host_ms["kernel"], plain_host_ms=host_ms["plain"],
               bound_ms=lamb_bound_ms(numel))
    print(f"[kernel] lamb_update {json.dumps(row)} card={card}", flush=True)
    del params, grads, opt, ref_p, ref_m, ref_v, tensors
    torch.cuda.empty_cache()
    return row


# the vitl14-relevancy-ours cell's smallest and largest tile chunks
TAIL_CHUNKS = (12, 105)
TAIL_LABELS = 9


def tail_backward_bound_ms(numel: int, dtype) -> float:
    """Least ms of one label's LayerNorm or quick-GELU backward over
    ``numel`` elements: g and x read and dx written once at
    ``benchmark/counts.py``'s HBM rate (the LayerNorm's per-row mean and
    1/std and its scale are under 0.3% more; a few flops an element)."""
    import torch

    from benchmark.counts import HBM_BYTES_PER_S

    return 1e3 * 3 * numel * torch.empty((), dtype=dtype).element_size() / HBM_BYTES_PER_S


def profiled_device_ms(fn, iters: int) -> float:
    """Mean device time of one ``fn`` call, the sum of its kernels' times
    in the torch profiler: for calls that a CUDA graph does not capture
    (autograd's batched backward)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / iters


def phase_tail_backward(card: str):
    """The LayerNorm and quick-GELU backward kernels (``ops/tail_backward``,
    replacing no Pallas kernel) at the ViT-L/14 cell's tile chunks
    ``TAIL_CHUNKS``, T = 257, the LayerNorm at W = 1024 and the GELU at its
    input's 4096, bf16 and f32: each read once against its plain version at
    the card test's tolerance (the error's largest share of it is printed),
    then device ms of one label's launch and of the plain version (CUDA
    graph replays), and a label's share of one batched backward over
    ``TAIL_LABELS`` labels as the general tail runs it (``is_grads_batched``,
    the profiler's kernel times): autograd's chain through the composite
    function, and the route (the kernel once a label and the legacy vmap's
    stack of the labels' results). Returns the rows."""
    import torch

    from semantic_abstraction_tpu_torch.clip import model as tm
    from semantic_abstraction_tpu_torch.ops import tail_backward as tb

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for b in TAIL_CHUNKS:
            for name in ("layer_norm", "quick_gelu"):
                w = 1024 if name == "layer_norm" else 4096
                x = (2 * torch.randn(b, 257, w, device="cuda", generator=gen) + 0.5).to(dtype)
                g9 = torch.randn(TAIL_LABELS, b, 257, w, device="cuda", generator=gen).to(dtype)
                scale = 1 + 0.3 * torch.randn(w, device="cuda", generator=gen)
                bias = 0.1 * torch.randn(w, device="cuda", generator=gen)
                if name == "layer_norm":
                    _, mean, rstd = tm._layer_norm(x, scale, bias, 1e-5)
                    args = (g9[0], x, mean, rstd, scale)
                    kernel, plain = tb.layer_norm_backward, tb.layer_norm_backward_reference
                    composite = lambda a: tm.layer_norm(a, scale, bias)  # noqa: E731
                    routed = lambda a: tm._LayerNorm.apply(a, scale, bias, 1e-5)  # noqa: E731
                else:
                    args = (g9[0], x)
                    kernel, plain = tb.quick_gelu_backward, tb.quick_gelu_backward_reference
                    composite, routed = tm.quick_gelu, tm._QuickGelu.apply
                out, ref = kernel(*args).float(), plain(*args).float()
                torch.cuda.synchronize()
                rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
                share = ((out - ref).abs() / (rel * ref.abs()
                         + 1e-5 * ref.abs().amax(dim=-1, keepdim=True))).max().item()
                if not share <= 1.0:
                    raise AssertionError(f"{name}_backward {dname} B={b}: error "
                                         f"{share} of the tolerance")
                del out, ref
                xr = x.detach().requires_grad_()
                y_comp, y_route = composite(xr), routed(xr)

                def batched(y):
                    torch.autograd.grad(y, xr, g9, is_grads_batched=True, retain_graph=True)

                row = dict(kernel=f"{name}_backward", dtype=dname, B=b, T=257, W=w,
                           tolerance_share=share,
                           ms=time_ms(lambda: kernel(*args), 20),
                           plain_ms=time_ms(lambda: plain(*args), 5),
                           autograd_ms=profiled_device_ms(lambda: batched(y_comp), 3)
                           / TAIL_LABELS,
                           route_ms=profiled_device_ms(lambda: batched(y_route), 3)
                           / TAIL_LABELS,
                           library_ms=None, bound_ms=tail_backward_bound_ms(x.numel(), dtype))
                rows.append(row)
                print(f"[kernel] tail_backward {json.dumps(row)} card={card}", flush=True)
                del x, g9, xr, y_comp, y_route, args
                torch.cuda.empty_cache()
    return rows


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
    from semantic_abstraction_tpu_torch.ops.lamb_update import grad_norm_reference

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
    grad_rel = (grad_norm_reference([b - f for b, f in zip(bg, fg)])
                / grad_norm_reference(fg)).item()
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
    """The OVSSC net at full width through the runtime's entry points
    (bench_train.py's workload): bf16 against f32, then a bf16 eval step.
    The cell ``ovssc-train-resident`` times its train step."""
    import torch

    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
    from semantic_abstraction_tpu_torch.runtime import make_eval_step, ovssc_forward_loss

    cfg = SemAbs3DConfig()
    t0 = time.perf_counter()
    model = init_net(0, cfg)
    batch = ovssc_batch(np.random.RandomState(0), 1, 4, 80000, 400000, "cuda")
    torch.cuda.synchronize()
    print(f"[ovssc] weights and batch built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_bf16_vs_f32(card, "ovssc-bf16", ovssc_forward_loss, cfg, model, batch)

    eval_step = make_eval_step(ovssc_forward_loss, cfg, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    aux = eval_step(model, batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if aux["logits"].shape != (1, 4, 400000) or not torch.isfinite(aux["logits"]).all():
        raise AssertionError(f"eval logits {tuple(aux['logits'].shape)} not finite")
    print(f"[ovssc] eval step {eval_s:.3f} s (loss {aux['loss'].item()}) card={card}",
          flush=True)


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
    return launches, sum(times) / len(times)


# the full-width corpus of scripts/bench_train_e2e.py: 480x640 frames,
# 500,000-point full clouds, 240x320 relevancy maps; 80,000 input and
# 400,000 query points a sample, 4 patches or descriptions
SCENE = dict(h=480, w=640, rel_h=240, rel_w=320, full_pts=500_000,
             num_input=80_000, num_output=400_000, parts=4)
LOOP_STEPS = 10
LOOP_WORKERS = 4


class MemoryScenes:
    """Scenes held in memory, served as the port's dataset items.

    The card's machine has no h5py, so the scene files cannot be read
    there. Each of ``n_scenes`` scenes (depth, rgb, a full point cloud with
    object ids, relevancy maps and their mean, CLIP label features) is drawn
    once from ``np.random.RandomState(seed + i)``; ``__getitem__`` then runs
    what ``SceneCompletionDataset`` / ``ObjectLocalizationDataset`` run after
    the HDF5 read, with the port's own transforms and native kernels, from a
    per-(seed, epoch, index) RandomState: back-projection, the relevancy
    resize and mean subtraction, the domain-randomization transform, the
    80,000-of-307,200 input subsample, the balanced 400,000-of-500,000
    query subsample of each patch or description, and the frustum masks.
    Items have the datasets' keys in their order, dtypes and ranks
    (``tests/test_torch_data.py`` holds them to a real item), and ``cfg`` is
    the ``DataConfig`` of these sizes, as on a dataset."""

    BOUNDS = np.array([[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9]], np.float32)
    RELATIONS = ("in", "behind", "in front of", "on the left of", "on the right of", "on")
    CLASSES = ("chair", "table", "sofa", "lamp", "bed", "mug", "plant", "tv")

    def __init__(self, task: str, n_scenes: int = 4, length: int = 11, seed: int = 0,
                 **sizes):
        from semantic_abstraction_tpu_torch.data import DataConfig

        self.task, self.length, self.seed, self.epoch = task, length, seed, 0
        self.size = {**SCENE, **sizes}
        z = self.size
        self.cfg = DataConfig(num_input_pts=z["num_input"], num_output_pts=z["num_output"],
                              num_patches=z["parts"], num_descs=z["parts"], seed=seed)
        self.scenes = []
        for i in range(n_scenes):
            rs = np.random.RandomState(seed + i)
            h, w, n, p = z["h"], z["w"], z["full_pts"], z["parts"]
            maps = 3 * p if task == "vool" else p  # target, reference, description
            self.scenes.append({
                "depth": rs.uniform(0.5, 1.8, (h, w)).astype(np.float32),
                "rgb": rs.randint(0, 255, (h, w, 3), np.uint8),
                "cam_intr": np.array([[w / 2, 0, w / 2], [0, w / 2, h / 2], [0, 0, 1]]),
                "cam_pose": np.eye(4),
                "full_xyz": rs.uniform(-0.9, 1.8, (n, 3)).astype(np.float32),
                "full_objid": rs.randint(0, len(self.CLASSES) + 3, n).astype(np.int64),
                "saliencies": rs.randn(maps, z["rel_h"], z["rel_w"]).astype(np.float32) * 0.01,
                "mean": rs.randn(z["rel_h"], z["rel_w"]).astype(np.float32) * 0.01,
                "label_features": rs.randn(p, 512).astype(np.float32),
                "targets": 3 + rs.choice(len(self.CLASSES), p, replace=False),
                "references": 3 + rs.choice(len(self.CLASSES), p, replace=False),
                "relations": rs.randint(0, len(self.RELATIONS), p),
            })

    def __len__(self):
        return self.length

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _relevancy(self, scene, rows):
        from semantic_abstraction_tpu_torch.data.transforms import resize_bilinear_np

        z = self.size
        maps = resize_bilinear_np(scene["saliencies"][rows] - scene["mean"], (z["h"], z["w"]))
        return (maps.reshape(len(rows), -1, 1) * 50.0).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        from semantic_abstraction_tpu_torch.data.transforms import (
            balanced_subsample_probabilities, check_pts_in_frustum_np,
            depth_to_pointcloud_np, random_domain_transform, transform_filter_subsample)

        z, sc = self.size, self.scenes[idx % len(self.scenes)]
        p, bounds = z["parts"], self.BOUNDS
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch * 10_007 + idx)
                                    % (2**31))
        names = [self.CLASSES[i - 3] for i in sc["targets"]]
        rgb = sc["rgb"].astype(np.float32)
        input_xyz = depth_to_pointcloud_np(sc["depth"], sc["cam_intr"], sc["cam_pose"])
        labels = (sc["full_objid"][None] == sc["targets"][:, None]).astype(np.float32)
        oob = np.zeros(len(sc["full_objid"]), np.float32)
        if self.task == "ovssc":
            side = {"input_feature_pts": self._relevancy(sc, np.arange(p))}
            transform = random_domain_transform(rng, bounds, 0.05, 0.3, 0.1)
        else:
            rel = [self._relevancy(sc, np.arange(p) + k * p) for k in range(3)]
            side = {"input_target_saliency_pts": rel[0],
                    "input_reference_saliency_pts": rel[1],
                    "input_description_saliency_pts": rel[2],
                    "input_rgb_pts": np.repeat((rgb / 255.0).reshape(1, -1, 3), p, axis=0)}
            transform = random_domain_transform(rng, bounds, 0.1, 0.3, 0.1)
        common = dict(scene_bounds=bounds, always_replace_pts=False, rng=rng)
        n_in = len(input_xyz)
        inp = transform_filter_subsample(
            xyz_pts=input_xyz, num_subsample_pts=z["num_input"],
            subsample_probabilities=np.full(n_in, 1.0 / n_in), transform_matrix=transform,
            **side, **common)
        xyzs, labs, oobs = [], [], []
        for i in range(p):
            o = transform_filter_subsample(
                xyz_pts=sc["full_xyz"], num_subsample_pts=z["num_output"],
                subsample_probabilities=balanced_subsample_probabilities(labels[i]),
                transform_matrix=transform, out_of_bounds_pts=oob,
                output_label_pts=labels[i][None], **common)
            xyzs.append(o["xyz_pts"])
            labs.append(o["output_label_pts"][0])
            oobs.append(o["out_of_bounds_pts"])
        frustum = np.stack([~check_pts_in_frustum_np(x, sc["depth"].shape, sc["cam_pose"],
                                                     sc["cam_intr"]) for x in xyzs])
        out_xyz, out_lab, out_oob = np.stack(xyzs), np.stack(labs), np.stack(oobs)
        scene_id = f"FloorPlan{idx % len(self.scenes) + 1}_physics_0"
        if self.task == "ovssc":
            return {
                "rgb": rgb, "output_xyz_pts": out_xyz,
                "input_feature_pts": inp["input_feature_pts"],
                "semantic_class_features": sc["label_features"],
                "output_label_pts": out_lab, "out_of_bounds_pts": out_oob,
                "patch_labels": names, "scene_id": scene_id,
                "input_xyz_pts": inp["xyz_pts"], "tsdf_vol": np.ones(1, np.float32),
                "out_of_frustum_pts_mask": frustum, "padding_mask": np.zeros(p, bool),
            }
        relations = [self.RELATIONS[r] for r in sc["relations"]]
        return {
            "rgb": rgb / 255.0, "input_xyz_pts": inp["xyz_pts"], "output_xyz_pts": out_xyz,
            "out_of_bounds_pts": out_oob, "spatial_relation_name": relations,
            **{k: inp[k] for k in side}, "output_label_pts": out_lab,
            "scene_id": scene_id, "target_obj_name": names,
            "reference_obj_name": [self.CLASSES[i - 3] for i in sc["references"]],
            "tsdf_vol": np.ones(1, np.float32), "out_of_frustum_pts_mask": frustum,
            "padding_mask": np.zeros(p, bool),
            "spatial_relation_id": sc["relations"].astype(np.int32),
        }


def phase_loop(card: str, task: str, resident_steps_per_s: float = None):
    """The loop users run, at full width, through the port's own
    ``runtime.experiment``: ``build_setup`` (the net of ``--approach
    semantic_abstraction`` at the CLI's defaults, bf16, LAMB on the
    schedule) over a ``MemoryScenes`` train split, then ``train`` for one
    epoch of LOOP_STEPS steps with LOOP_WORKERS loader threads (no eval
    split inside it), then the eval half through ``eval_batches`` (loader,
    ``device_batch``, the eval step, ``point_and_voxel_stats`` at the 25
    detailed cutoffs and 32^3 and 64^3 voxels) over 2 batches, then a
    ``latest.ckpt`` round trip into a fresh state, bit for bit.
    ``resident_steps_per_s``, where given, is the device-resident step rate
    of the same net from its earlier phase. Returns the moments and the
    clip + LAMB launches of the epoch (33 + 33 and 3 a step) and its
    steps."""
    import torch

    from semantic_abstraction_tpu_torch import native
    from semantic_abstraction_tpu_torch.cli import common
    from semantic_abstraction_tpu_torch.data import DataLoader, ShardedSampler
    from semantic_abstraction_tpu_torch.models import init_net
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.ops.lamb_update import global_grad_norm, lamb_update_
    from semantic_abstraction_tpu_torch.runtime import experiment as exp
    from semantic_abstraction_tpu_torch.runtime import (
        eval_cutoffs_for, load_checkpoint, make_eval_step, save_checkpoint)
    from semantic_abstraction_tpu_torch.runtime.train import init_train_state

    if not native.available():
        raise AssertionError("the native loader kernels did not build on the card's machine")
    args = common.config_parser().parse_args([
        "--file_path", "(in memory)", "--epochs", "1", "--eval_freq", "1000",
        "--save_freq", "1000", "--num_workers", str(LOOP_WORKERS), "--seed", "0"])
    t0 = time.perf_counter()
    train_ds = MemoryScenes(task, length=LOOP_STEPS + 1)
    setup = exp.build_setup(args, task, "semantic_abstraction", {"train": train_ds})
    device = setup["device"]
    torch.cuda.synchronize()
    print(f"[loop-{task}] scenes and net built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    timings = []
    with tempfile.TemporaryDirectory() as log_dir:
        torch.cuda.reset_peak_memory_stats()
        channel_moments.launches = channel_moments_backward.launches = 0
        global_grad_norm.launches = lamb_update_.launches = 0
        state = exp.train(args, setup, log_dir=log_dir, max_steps_per_epoch=LOOP_STEPS,
                          timings=timings)
        launches = {"channel_moments": channel_moments.launches,
                    "channel_moments_backward": channel_moments_backward.launches,
                    "lamb_update": global_grad_norm.launches + lamb_update_.launches}
        peak = torch.cuda.max_memory_allocated() / 1e9
        (t,) = timings
        if t["steps"] != LOOP_STEPS or not np.isfinite(t["loss"]):
            raise AssertionError(f"loop-{task}: train epoch {t}")
        per_step = {k: n / t["steps"] for k, n in launches.items()}
        if per_step != {"channel_moments": 33.0, "channel_moments_backward": 33.0,
                        "lamb_update": 3.0}:
            raise AssertionError(f"loop-{task}: moments and clip + LAMB launches a step "
                                 f"{per_step}")

        # H2D: device_batch of one loader batch, pinned and non-blocking,
        # to the synchronize; the mean of 5 after one warm-up
        batch = next(iter(DataLoader(train_ds, batch_size=1, num_workers=0, shuffle=False)))
        nbytes = sum(v.nbytes for k, v in batch.items() if k in exp.DEVICE_KEYS[task])
        h2d = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            db = exp.device_batch(batch, task, device)
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t1)
        h2d_ms = 1e3 * sum(h2d[1:]) / 5
        del db

        # the eval half: 2 batches at the 25 detailed cutoffs
        eval_step = make_eval_step(setup["forward_loss"], setup["cfg"],
                                   compute_dtype=torch.bfloat16)
        cutoffs = eval_cutoffs_for(task, detailed=True)
        loader = DataLoader(MemoryScenes(task, length=2, seed=100), batch_size=1,
                            num_workers=2,
                            sampler=ShardedSampler(2, shuffle=False, seed=args.seed))
        t1 = time.perf_counter()
        outs = list(exp.eval_batches(state, eval_step, loader, task,
                                     train_ds.cfg.scene_bounds, cutoffs,
                                     ((32, 32, 32), (64, 64, 64)), max_batches=2))
        eval_s = time.perf_counter() - t1
        losses = [x for o in outs for x in o["loss"]]
        # mean 32^3 voxel IoU by cutoff over both batches' 4 rows
        ious = np.nanmean(np.stack([o["stats"]["voxel32x32x32_iou"] for o in outs]),
                          axis=(0, 2, 3))
        if len(outs) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"loop-{task} eval: {len(outs)} batches, losses {losses}")
        for o in outs:
            for k, v in o["stats"].items():
                if v.shape != (25, 1, 4) or not np.isfinite(v[~np.isnan(v)]).all() \
                        or np.isnan(v).all():
                    raise AssertionError(f"loop-{task} eval stat {k}: {v.shape}")

        # checkpoint round trip into a fresh state (another seed's weights)
        path = os.path.join(log_dir, "latest.ckpt")
        save_checkpoint(path, state, 1)
        fresh = init_train_state(init_net(1, setup["cfg"], device), setup["tx"])
        fresh, epoch, _ = load_checkpoint(path, fresh)
        if epoch != 1 or fresh.step != state.step:
            raise AssertionError(f"loop-{task} checkpoint: epoch {epoch} step {fresh.step}")
        for (n, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
            if not torch.equal(a, b):
                raise AssertionError(f"loop-{task} checkpoint: parameter {n} differs")
        for a, b in zip(state.model.parameters(), fresh.model.parameters()):
            sa, sb = state.optimizer.state[a], fresh.optimizer.state[b]
            if sa["step"] != sb["step"] or not all(
                    torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq")):
                raise AssertionError(f"loop-{task} checkpoint: LAMB state differs")
    resident = ("" if resident_steps_per_s is None else
                f" (device-resident {resident_steps_per_s} steps/s in its phase)")
    print(f"[loop-{task}] {t['steps']} loader-fed steps in {t['wall_s']:.3f} s = "
          f"{t['steps'] / t['wall_s']} steps/s{resident}; waited on the loader "
          f"{t['loader_wait_s']:.3f} s = "
          f"{100 * t['loader_wait_s'] / t['wall_s']:.1f}% of the epoch; device_batch "
          f"{t['device_batch_s']:.3f} s on the host clock; H2D {h2d_ms:.2f} ms a batch "
          f"({nbytes / 1e6:.1f} MB, {nbytes / h2d_ms / 1e6:.2f} GB/s); peak mem GB "
          f"{peak:.2f}; moments and clip + LAMB launches a step {per_step}; loss "
          f"{t['loss']}; eval "
          f"{len(outs)} batches in {eval_s:.3f} s, loss {losses}, mean 32^3 voxel IoU by "
          f"cutoff {[round(v, 4) for v in ious.tolist()]}; "
          f"checkpoint round trip bit-equal; native.available() "
          f"{native.available()}; {LOOP_WORKERS} loader threads card={card}", flush=True)
    return launches, t["steps"]


# OpenAI RN50's shape: 4 stages of (3, 4, 6, 3) bottlenecks at width 64,
# a 1024-wide embedding, the 32-head attention pool at 224 px, and a
# 12-block text tower of width 512
RN50 = dict(layers=(3, 4, 6, 3), width=64, resolution=224, embed_dim=1024,
            text_width=512, text_layers=12, context_length=77, vocab_size=49408)


def resnet_clip_state_dict(seed: int, layers=(3, 4, 6, 3), width: int = 64,
                           resolution: int = 224, embed_dim: int = 1024,
                           text_width: int = 512, text_layers: int = 12,
                           context_length: int = 77, vocab_size: int = 49408) -> dict:
    """A ModifiedResNet CLIP state dict in the reference layout (what
    ``torch.jit.load`` of an OpenAI RN checkpoint gives, BatchNorm's
    ``num_batches_tracked`` included), numpy arrays drawn from
    ``np.random.RandomState(seed)``: He-scaled convs, BatchNorm statistics
    and affines near identity (the last of each bottleneck at 0.2, so the
    residual stream grows slowly), linears at 1/sqrt(fan-in). No
    checkpoint is in the repo; the weights are random."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    sd = {}

    def conv(key, c_out, c_in, k):
        sd[key + ".weight"] = (rs.randn(c_out, c_in, k, k) * np.sqrt(2.0 / (c_in * k * k))
                               ).astype(f32)

    def bn(key, n, gain=1.0):
        sd[key + ".weight"] = (rs.uniform(0.5, 1.0, n) * gain).astype(f32)
        sd[key + ".bias"] = (rs.randn(n) * 0.1).astype(f32)
        sd[key + ".running_mean"] = (rs.randn(n) * 0.1).astype(f32)
        sd[key + ".running_var"] = rs.uniform(0.5, 1.5, n).astype(f32)
        sd[key + ".num_batches_tracked"] = np.array(0, np.int64)

    def linear(key, d_out, d_in):
        sd[key + ".weight"] = (rs.randn(d_out, d_in) * d_in**-0.5).astype(f32)
        sd[key + ".bias"] = (rs.randn(d_out) * 0.01).astype(f32)

    conv("visual.conv1", width // 2, 3, 3)
    bn("visual.bn1", width // 2)
    conv("visual.conv2", width // 2, width // 2, 3)
    bn("visual.bn2", width // 2)
    conv("visual.conv3", width, width // 2, 3)
    bn("visual.bn3", width)
    inplanes = width
    for i, n in enumerate(layers):
        planes = width * 2**i
        for b in range(n):
            base = f"visual.layer{i + 1}.{b}"
            conv(base + ".conv1", planes, inplanes, 1)
            bn(base + ".bn1", planes)
            conv(base + ".conv2", planes, planes, 3)
            bn(base + ".bn2", planes)
            conv(base + ".conv3", planes * 4, planes, 1)
            bn(base + ".bn3", planes * 4, gain=0.2)
            if b == 0:  # stride 2, or inplanes != 4 * planes at layer 1
                conv(base + ".downsample.0", planes * 4, inplanes, 1)
                bn(base + ".downsample.1", planes * 4)
            inplanes = planes * 4
    embed = width * 32
    sd["visual.attnpool.positional_embedding"] = (
        rs.randn((resolution // 32) ** 2 + 1, embed) * embed**-0.5).astype(f32)
    for n in ("k", "q", "v"):
        linear(f"visual.attnpool.{n}_proj", embed, embed)
    linear("visual.attnpool.c_proj", embed_dim, embed)

    tw = text_width
    sd["token_embedding.weight"] = (rs.randn(vocab_size, tw) * 0.02).astype(f32)
    sd["positional_embedding"] = (rs.randn(context_length, tw) * 0.01).astype(f32)
    for i in range(text_layers):
        base = f"transformer.resblocks.{i}"
        sd[base + ".attn.in_proj_weight"] = (rs.randn(3 * tw, tw) * tw**-0.5).astype(f32)
        sd[base + ".attn.in_proj_bias"] = np.zeros(3 * tw, f32)
        linear(base + ".attn.out_proj", tw, tw)
        linear(base + ".mlp.c_fc", 4 * tw, tw)
        linear(base + ".mlp.c_proj", tw, 4 * tw)
        for ln in ("ln_1", "ln_2"):
            sd[f"{base}.{ln}.weight"] = np.ones(tw, f32)
            sd[f"{base}.{ln}.bias"] = np.zeros(tw, f32)
    sd["ln_final.weight"] = np.ones(tw, f32)
    sd["ln_final.bias"] = np.zeros(tw, f32)
    sd["text_projection"] = (rs.randn(tw, embed_dim) * tw**-0.5).astype(f32)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), f32)
    return sd


# the writer's in-memory corpus: THOR-like object lists (20 names, ids from
# 3 as the THOR files number them) and 6 descriptions a scene
THOR_OBJECTS = ("chair", "table", "sofa", "television", "lamp", "bed", "pillow", "plant",
                "book", "mug", "laptop", "cabinet", "drawer", "shelf", "painting",
                "window", "door", "fridge", "armchair", "desk")
WRITER_SCENES = 3
WRITER_STORE = (240, 320)
# the inference scene: classes (OVSSC) and descriptions (VOOL)
INFERENCE_CLASSES = ["chair", "table", "sofa", "lamp"]
INFERENCE_DESCRIPTIONS = [("mug", "on", "table"), ("lamp", "behind", "sofa")]
INFERENCE_GRID = 240
# the random net's outputs are noise at the voxel scale (most within
# +-0.1), so its argmax over the 4 classes changes every voxel or two: with
# no point empty, the meshes would run through the whole carved region.
# The cutoff empties the points whose best output is below it, which
# leaves small blobs to mesh; phase 15 prints how many points it kept
INFERENCE_CUTOFF = 0.08


def writer_items(n: int, seed: int = 0):
    """``n`` in-memory scenes (index, labels, 480x640 rgb): each scene's
    labels come from the port's ``_scene_labels`` over a THOR-like
    ``objid_to_class`` (the placeholders, 20 bracketed names) and 6
    descriptions, as the writer reads them from a scene file (no ground
    truth, so every class)."""
    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.models import RELATIONS

    items = []
    for si in range(n):
        rs = np.random.RandomState(seed + si)
        names = ["empty", "out of bounds", "unlabelled"] + [
            f"{c}[{i + 3}]" for i, c in enumerate(THOR_OBJECTS)]
        descs = {"target_obj_name": rs.choice(THOR_OBJECTS, 6),
                 "reference_obj_name": rs.choice(THOR_OBJECTS, 6),
                 "spatial_relation_name": rs.choice(RELATIONS[:6], 6)}
        f = {"data": {"objid_to_class": np.array(names, "S64"),
                      "descriptions": {k: np.array(v, "S64") for k, v in descs.items()}}}
        items.append((si, cli._scene_labels(f),
                      rs.randint(0, 255, (480, 640, 3), np.uint8)))
    return items


def phase_writer(card: str):
    """The ``generate_relevancy dataset`` writer at full width without
    h5py: ``extract_scene`` (ViT-B/32, random weights, bf16, "ours", the
    downsample to the 240x320 store on the card) over WRITER_SCENES
    in-memory 480x640 scenes through ``pipelined``, one scene deep, into an
    in-memory sink that forms the rows the HDF5 writer stores
    (``scene_rows``). A warm-up extraction of the last scene, synchronous,
    is the reference for the sink's copy of it (the pipelined copy must
    equal it within 2 float16 ulp of the largest map value: the
    overlap-add canvas may sum in another order from run to run)."""
    import torch

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    args = cli.parser().parse_args(["dataset", "(in memory)", "--random-weights"])
    sal = cli.build_saliency(args)
    prompt = cli.dataset_prompt(args)
    items = writer_items(WRITER_SCENES)

    def extract(item):
        si, labels, img = item
        return cli.extract_scene(sal, img, labels, prompt, args.saliency_config,
                                 args.seed + si, WRITER_STORE)

    t0 = time.perf_counter()
    ref_maps, _ = extract(items[-1])
    ref_maps = ref_maps.float().cpu().numpy()
    print(f"[writer] warm-up scene {time.perf_counter() - t0:.3f} s", flush=True)

    sink = []

    def write(item, arrays):
        maps, feats = arrays
        raw_mean = feats.mean(axis=0)
        rows, frows = cli.scene_rows(maps, feats)
        sink.append((item[0], item[1], maps.astype(np.float32), rows, frows, raw_mean))

    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mha.launches = 0
    t0 = time.perf_counter()
    failures = cli.pipelined(items, extract, write, sal.device, stats=stats)
    wall = time.perf_counter() - t0
    launches = fused_mha.launches
    peak = torch.cuda.max_memory_allocated() / 1e9

    if failures or [s[0] for s in sink] != list(range(WRITER_SCENES)):
        raise AssertionError(f"writer: {failures} failures, sink order {[s[0] for s in sink]}")
    n_maps = 0
    for si, labels, maps, rows, frows, raw_mean in sink:
        n_maps += len(labels)
        if maps.shape != (len(labels),) + WRITER_STORE or not np.isfinite(maps).all():
            raise AssertionError(f"writer scene {si}: maps {maps.shape}")
        if rows.shape[0] != len(labels) + 1 or frows.shape != (len(labels) + 1, 512):
            raise AssertionError(f"writer scene {si}: rows {rows.shape} {frows.shape}")
        if np.abs(np.linalg.norm(frows, axis=-1) - 1).max() > 1e-5 or np.abs(
                frows[-1] - raw_mean / np.linalg.norm(raw_mean)).max() > 1e-6:
            raise AssertionError(f"writer scene {si}: features not unit-norm or no mean row")
    diff = np.abs(sink[-1][2] - ref_maps).max()
    if diff > 2.0**-9 * np.abs(ref_maps).max():
        raise AssertionError(f"writer: the pipelined copy of the last scene is {diff} off "
                             "its synchronous extraction")
    if launches <= 0:
        raise AssertionError("the writer launched no fused_mha kernel")
    print(f"[writer] {WRITER_SCENES} scenes ({[len(s[1]) for s in sink]} labels, "
          f"store {WRITER_STORE}) in {wall:.3f} s = {wall / WRITER_SCENES:.3f} s a scene, "
          f"{n_maps / wall} maps/s; copies {json.dumps(stats)}; fused_mha launches "
          f"{launches} = {launches / WRITER_SCENES} a scene; peak mem GB {peak:.2f}; "
          f"pipelined vs synchronous max diff {diff} card={card}", flush=True)
    return launches, stats


def inference_scene(directory: str) -> str:
    """A seeded 480x640 RGB-D scene pickle (the ``visualize`` input): a
    wavy back wall 1.3-1.8 m away and a box 0.8 m away, seen from the
    origin, with INFERENCE_CLASSES and INFERENCE_DESCRIPTIONS."""
    import pickle

    h, w = 480, 640
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (1.55 + 0.25 * np.sin(xx / 60.0) * np.cos(yy / 45.0)).astype(np.float32)
    depth[300:420, 100:300] = 0.8
    scene = {"rgb": rs.randint(0, 255, (h, w, 3), dtype=np.uint8), "depth": depth,
             "cam_intr": np.array([[w / 2, 0, w / 2], [0, w / 2, h / 2], [0, 0, 1]],
                                  np.float32),
             "cam_extr": np.eye(4, dtype=np.float32),
             "ovssc_obj_classes": INFERENCE_CLASSES,
             "descriptions": INFERENCE_DESCRIPTIONS}
    path = os.path.join(directory, "scene.pkl")
    with open(path, "wb") as f:
        pickle.dump(scene, f)
    return path


def _inference_args(command: str, scene: str, dump: str):
    from semantic_abstraction_tpu_torch.cli import visualize as vis

    g = str(INFERENCE_GRID)
    return vis.parser().parse_args([
        command, scene, "--random-weights", "--sampling_shape", g, g, g,
        "--num_input_pts", "80000", "--cutoff", str(INFERENCE_CUTOFF), "--dump-path", dump])


def tsdf_ties(diff_idx, vox_world, depth, intr, pose, trunc, eps=1e-4):
    """Which of the voxels ``diff_idx`` sit at a rounding tie of the fusion:
    the pixel within ``eps`` of a half pixel, or the depth difference within
    ``eps`` of the truncation margin (float64, the JAX package's formula)."""
    h, w = depth.shape
    inv = np.linalg.inv(np.asarray(pose, np.float64))
    cam = vox_world[diff_idx].astype(np.float64) @ inv[:3, :3].T + inv[:3, 3]
    z = np.where(cam[:, 2] == 0, 1e-12, cam[:, 2])
    px = cam[:, 0] * intr[0, 0] / z + intr[0, 2]
    py = cam[:, 1] * intr[1, 1] / z + intr[1, 2]
    tie = np.zeros(len(diff_idx), bool)
    for q in (px, py):
        tie |= np.abs(np.abs(q - np.floor(q)) - 0.5) < eps
    ix = np.clip(np.round(px), 0, w - 1).astype(int)
    iy = np.clip(np.round(py), 0, h - 1).astype(int)
    return tie | (np.abs(depth[iy, ix] - cam[:, 2] + trunc) < eps)


def phase_tsdf(card: str, scene: str):
    """TSDF fusion of the inference frame at INFERENCE_GRID^3 on the card
    against the same on the CPU: tsdf and weight within 1e-5, every voxel that differs
    counted and attributed to a rounding tie (``tsdf_ties``); and the host
    seconds of the ``tsdf`` network input of a dataset item (a 128^3 volume
    fused on the CPU, as the datasets do)."""
    import pickle

    import torch

    from semantic_abstraction_tpu_torch.ops.fusion import TSDFVolume

    with open(scene, "rb") as f:
        data = pickle.load(f)
    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0], [-0.1, 1.9]])
    frame = (data["rgb"], data["depth"], data["cam_intr"], data["cam_extr"])
    vols, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        vols[dev] = TSDFVolume(bounds, voxel_size=2.0 / INFERENCE_GRID, device=dev)
        vols[dev].integrate(*frame)
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    g, c = vols["cuda"], vols["cpu"]
    dt = (g._tsdf.cpu() - c._tsdf).abs()
    dw = (g._weight.cpu() - c._weight).abs()
    differ = ((dt > 1e-5) | (dw > 1e-5)).nonzero().reshape(-1).numpy()
    ties = tsdf_ties(differ, c._vox_world.numpy(), data["depth"], data["cam_intr"],
                     data["cam_extr"], c._trunc_margin)
    if not ties.all():
        raise AssertionError(f"tsdf: {int((~ties).sum())} of {len(differ)} differing "
                             "voxels are not at a rounding tie")
    observed = int((c._weight > 0).sum())
    del vols, g, c
    t0 = time.perf_counter()
    item = TSDFVolume(bounds, voxel_size=2.0 / 128, device="cpu")
    item.integrate(data["rgb"], data["depth"], data["cam_intr"], data["cam_extr"])
    item.get_volume()
    item_s = time.perf_counter() - t0
    print(f"[tsdf] {INFERENCE_GRID}^3 card {secs['cuda']:.3f} s, cpu {secs['cpu']:.3f} s (volume "
          f"built and one 480x640 frame); {observed} voxels observed; tsdf max diff "
          f"{dt.max().item()}, weight max diff {dw.max().item()}; {len(differ)} voxels "
          f"differ beyond 1e-5, {int(ties.sum())} of them at a rounding tie; dataset "
          f"item 128^3 on the host {item_s:.3f} s card={card}", flush=True)


def phase_inference(card: str, task: str, scene: str, dump: str):
    """``visualize ovssc-inference`` or ``vool-inference`` at full width
    through the CLI's own commands: random weights (seed 0, the
    ``SemAbs3DConfig()`` / ``SemAbsVOOLConfig()`` of the CLI's defaults),
    bf16, the relevancy of "ours" on the 480x640 frame, 80,000 input points,
    the 240^3 sweep; the seconds of each stage (the device synchronized at
    each stage's end), the kernel launches of the run and peak memory.
    OVSSC: meshes are written and K3 runs 33 times a class; VOOL: a point
    cloud a description and 66 K3 launches each (target and reference)."""
    import torch

    from semantic_abstraction_tpu_torch.cli import visualize as vis
    from semantic_abstraction_tpu_torch.ops.channel_moments import channel_moments
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    args = _inference_args(f"{task}-inference", scene, dump)
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mha.launches = channel_moments.launches = 0
    t0 = time.perf_counter()
    out = (vis.cmd_ovssc if task == "ovssc" else vis.cmd_vool)(args, timings)
    wall = time.perf_counter() - t0
    launches = {"fused_mha": fused_mha.launches, "channel_moments": channel_moments.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9

    n = INFERENCE_GRID
    if task == "ovssc":
        per = len(INFERENCE_CLASSES)
        pred, keep = out["prediction"], out["keep"]
        if pred.shape != (n, n, n) or keep.shape != (n, n, n) or not keep.any():
            raise AssertionError(f"ovssc inference: prediction {pred.shape}, "
                                 f"{int(keep.sum())} points kept")
        if not out["written"]:
            raise AssertionError("ovssc inference wrote no mesh")
        extra = (f"{int(keep.sum())} of {n**3} points kept, class counts there "
                 f"{np.bincount(pred[keep], minlength=per).tolist()}, meshes "
                 f"{[(os.path.basename(p), os.path.getsize(p)) for p in out['written']]}")
        want_k3 = 33 * per
    else:
        per = len(INFERENCE_DESCRIPTIONS)
        logits = out["logits"]
        if len(logits) != per or any(v.shape != (n**3,) or not np.isfinite(v).all()
                                     for v in logits.values()):
            raise AssertionError("vool inference: logits not finite or of another shape")
        extra = (f"logit ranges {[(float(v.min()), float(v.max())) for v in logits.values()]}, "
                 f"files {[(os.path.basename(p), os.path.getsize(p)) for p in out['written']]}")
        want_k3 = 66 * per
    if launches["channel_moments"] != want_k3 or launches["fused_mha"] <= 0:
        raise AssertionError(f"{task} inference launches {launches}, K3 expected {want_k3}")
    print(f"[{task}-inference] wall {wall:.3f} s; stage seconds "
          f"{json.dumps({k: round(v, 4) for k, v in timings.items()})}; launches {launches}; "
          f"peak mem GB {peak:.2f}; {extra} card={card}", flush=True)
    return launches, timings


# ---------------------------------------------------------------------------
# data parallelism (phases 16 and 17): ranks are copies of this script
# ---------------------------------------------------------------------------

# the world-size-1 NCCL run: --batch_size rows a step, loader-fed steps, of
# which the first DDP_COMPARED are held against one process
DDP_BATCH = 4
DDP_STEPS = 10
DDP_COMPARED = 3
# its stated tolerance: bf16 steps that differ only in the order of the
# scatter's and the sampler backward's atomics
DDP_LOSS_RTOL, DDP_GRAD_NORM_RTOL = 1e-3, 1e-2
# the 2-rank gloo run on the one card: 2 rows a rank of GLOO_PATCHES
# patches (one process then holds 8 volumes of 128^3 in f32), f32 with TF32
# off, GLOO_STEPS steps at the train CLI's recipe (lr 1e-3 after 1024
# warm-up steps, as phases 7 and 16). At lr 1e-2 without warm-up, LAMB's
# first update (close to lr x sign(g)) turns f32 order differences in
# near-zero gradients into whole-update differences, and the second step's
# grad norm moved 1.9e-4 from one process's (on an H100 80GB HBM3)
GLOO_WORLD, GLOO_ROWS, GLOO_PATCHES, GLOO_STEPS = 2, 2, 2, 2
GLOO_OPT = dict(num_training_steps=1000)
# its stated tolerance, phase 3's for f32 steps whose sums run in another
# order (cuDNN picks its algorithms per batch size)
GLOO_RTOL, GLOO_ATOL = 1e-4, 1e-5
RANK_TIMEOUT_S = 420


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(mode: str, world: int, out_dir: str, share_card: bool = False,
              env: dict = None) -> list:
    """``world`` copies of this script as the ranks of ``mode``, with the
    environment torch.distributed.run gives them (LOCAL_RANK 0 for every
    rank when they share the card). Fails when any rank fails or outlives
    RANK_TIMEOUT_S; every rank is killed then. -> each rank's JSON."""
    port = str(_free_port())
    procs, logs = [], []
    for r in range(world):
        renv = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                    LOCAL_RANK="0" if share_card else str(r), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=port, **(env or {}))
        log = open(os.path.join(out_dir, f"{mode}-rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of", mode, out_dir],
            env=renv, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-4000:])
        log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{mode}: ranks exited {codes}:\n" + "\n---\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{mode}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def ddp_loop_args(device: str):
    from semantic_abstraction_tpu_torch.cli import common

    return common.config_parser().parse_args([
        "--file_path", "(in memory)", "--epochs", "1", "--eval_freq", "1000",
        "--save_freq", "1000", "--num_workers", str(LOOP_WORKERS), "--seed", "0",
        "--batch_size", str(DDP_BATCH), "--device", device])


def loop_train(args, steps: int, log_dir: str):
    """``experiment.build_setup`` + ``train`` of the OVSSC net over
    ``MemoryScenes`` for ``steps`` loader-fed steps -> (timing record,
    moments launches, peak GB, whether the step was data-parallel)."""
    import torch

    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.runtime import experiment as exp

    # one length for both runs: the sampler's shuffle depends on it
    train_ds = MemoryScenes("ovssc", length=DDP_STEPS * DDP_BATCH + 1)
    setup = exp.build_setup(args, "ovssc", "semantic_abstraction", {"train": train_ds})
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    channel_moments.launches = channel_moments_backward.launches = 0
    exp.train(args, setup, log_dir=log_dir, max_steps_per_epoch=steps, timings=timings)
    launches = {"channel_moments": channel_moments.launches,
                "channel_moments_backward": channel_moments_backward.launches}
    return timings[0], launches, torch.cuda.max_memory_allocated() / 1e9, \
        setup["data_parallel"]


def gloo_batch(device):
    """The OVSSC batch of ``ovssc_batch`` at GLOO_WORLD x GLOO_ROWS rows of
    GLOO_PATCHES patches, whose halves keep different numbers of points:
    the third row's first patch is padding, a third of the fourth row's
    query points are out of bounds."""
    b = ovssc_batch(np.random.RandomState(0), GLOO_WORLD * GLOO_ROWS, GLOO_PATCHES,
                    80000, 400000, "cpu")
    b["padding_mask"][2, 0] = True
    b["out_of_bounds_pts"][3, :, : 400000 // 3] = True
    return {k: v.to(device) for k, v in b.items()}


def gloo_steps(device, data_parallel: bool):
    """GLOO_STEPS f32 steps of ``SemAbs3DConfig()`` from seed 0's weights on
    ``gloo_batch`` (this rank's rows when ``data_parallel``) -> (stats,
    parameters on the host, moments launches, seconds a step)."""
    import torch

    from semantic_abstraction_tpu_torch import parallel
    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig, init_net
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_optimizer, make_train_step, ovssc_forward_loss)

    cfg = SemAbs3DConfig()
    tx = make_optimizer(**GLOO_OPT)
    state = init_train_state(init_net(0, cfg, device), tx)
    step = make_train_step(ovssc_forward_loss, cfg, tx, compute_dtype=torch.float32,
                           data_parallel=data_parallel)
    batch = gloo_batch(device)
    if data_parallel:
        r = parallel.rank()
        batch = {k: v[r * GLOO_ROWS:(r + 1) * GLOO_ROWS] for k, v in batch.items()}
    torch.cuda.synchronize()
    channel_moments.launches = channel_moments_backward.launches = 0
    stats, times = [], []
    for _ in range(GLOO_STEPS):
        t0 = time.perf_counter()
        state, st = step(state, batch)
        stats.append({k: float(v) for k, v in st.items()})
        times.append(time.perf_counter() - t0)
    launches = {"channel_moments": channel_moments.launches,
                "channel_moments_backward": channel_moments_backward.launches}
    params = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
    return stats, params, launches, times


def rank_main(mode: str, out_dir: str) -> int:
    """One rank of phase 16 ("nccl": the world-size-1 loop) or 17 ("gloo":
    the 2-rank steps sharing the card); its results go to
    ``out_dir/<mode>-rank<r>.json`` (and ``.pt``, the parameters)."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from semantic_abstraction_tpu_torch import parallel

    if mode == "gloo":
        dist.init_process_group("gloo")  # NCCL takes one card a rank
    device = parallel.maybe_initialize_distributed("cuda")
    r = parallel.rank()
    try:
        out = {"backend": dist.get_backend(), "world": parallel.world_size(), "rank": r,
               "device": str(device)}
        if mode == "nccl":
            with tempfile.TemporaryDirectory() as log_dir:
                record, launches, peak, dp = loop_train(
                    ddp_loop_args(str(device)), DDP_STEPS, log_dir)
                out.update(record=record, launches=launches, peak_gb=peak,
                           data_parallel=dp, wrote=sorted(os.listdir(log_dir)))
        else:
            stats, params, launches, times = gloo_steps(device, data_parallel=True)
            torch.save(params, os.path.join(out_dir, f"{mode}-rank{r}.pt"))
            out.update(stats=stats, launches=launches, step_s=times,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        with open(os.path.join(out_dir, f"{mode}-rank{r}.json"), "w") as f:
            json.dump(out, f)
    finally:
        parallel.destroy_distributed()
    return 0


def phase_ddp_loop(card: str):
    """Phase 16: ``SemAbs3DConfig()`` at --batch_size 4, bf16, through
    ``experiment.train`` as phase 12 drives it, in one rank of a NCCL group
    of world size 1 (the train step under DDP), then one process without a
    group from the same seed and items: the first DDP_COMPARED steps' loss
    and grad norm must agree (DDP_LOSS_RTOL, DDP_GRAD_NORM_RTOL)."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        (rank,) = run_ranks("nccl", 1, out_dir, env={"SEMABS_DISTRIBUTED": "1"})
    t = rank["record"]
    if not (rank["backend"] == "nccl" and rank["data_parallel"]
            and t["steps"] == DDP_STEPS and np.isfinite(t["losses"]).all()):
        raise AssertionError(f"ddp-nccl: {rank}")
    per_step = {k: n / t["steps"] for k, n in rank["launches"].items()}
    if per_step != {"channel_moments": 33.0, "channel_moments_backward": 33.0}:
        raise AssertionError(f"ddp-nccl: moments launches a step {per_step}")
    with tempfile.TemporaryDirectory() as log_dir:
        single, _, _, dp = loop_train(ddp_loop_args("cuda"), DDP_COMPARED, log_dir)
    if dp:
        raise AssertionError("the single process ran data-parallel")
    worst = {}
    for k, tol in (("losses", DDP_LOSS_RTOL), ("grad_norms", DDP_GRAD_NORM_RTOL)):
        a, b = np.asarray(t[k][:DDP_COMPARED]), np.asarray(single[k])
        worst[k] = float(np.max(np.abs(a - b) / np.abs(b)))
        if len(b) != DDP_COMPARED or worst[k] > tol:
            raise AssertionError(f"ddp-nccl {k}: DDP {a.tolist()} one process "
                                 f"{b.tolist()} (rtol {tol})")
    print(f"[ddp-nccl] world size 1 over {rank['backend']} on {rank['device']}, batch "
          f"{DDP_BATCH}: {t['steps']} loader-fed steps in {t['wall_s']:.3f} s = "
          f"{t['steps'] / t['wall_s']} steps/s; waited on the loader "
          f"{t['loader_wait_s']:.3f} s; "
          f"peak mem GB {rank['peak_gb']:.2f}; moments launches a step {per_step}; wrote "
          f"{rank['wrote']}; losses {t['losses']} grad norms {t['grad_norms']}; first "
          f"{DDP_COMPARED} steps against one process: losses {single['losses']} grad norms "
          f"{single['grad_norms']}, worst relative gap {worst} (rtol {DDP_LOSS_RTOL}, "
          f"{DDP_GRAD_NORM_RTOL}) card={card}", flush=True)
    return rank["launches"], t["steps"]


def phase_ddp_gloo(card: str):
    """Phase 17: 2 ranks over gloo sharing the one card, GLOO_STEPS f32
    steps of ``SemAbs3DConfig()`` at 2 rows a rank whose halves keep
    different point counts, against one process at B = 4 from the same
    weights: loss, accuracy and grad norm at each step and every parameter
    after the last within GLOO_RTOL, GLOO_ATOL."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = run_ranks("gloo", GLOO_WORLD, out_dir, share_card=True)
        params = [torch.load(os.path.join(out_dir, f"gloo-rank{r}.pt"), weights_only=True)
                  for r in range(GLOO_WORLD)]
    torch.cuda.reset_peak_memory_stats()
    stats, want, _, times = gloo_steps("cuda", data_parallel=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    worst_stat, worst_param = 0.0, 0.0
    for rank, got in zip(ranks, params):
        if rank["backend"] != "gloo" or rank["world"] != GLOO_WORLD:
            raise AssertionError(f"ddp-gloo: {rank}")
        per_step = {k: n / GLOO_STEPS for k, n in rank["launches"].items()}
        if per_step != {"channel_moments": 33.0, "channel_moments_backward": 33.0}:
            raise AssertionError(f"ddp-gloo rank {rank['rank']}: moments a step {per_step}")
        for i, (a, b) in enumerate(zip(rank["stats"], stats)):
            for k in ("loss", "accuracy", "grad_norm"):
                gap = abs(a[k] - b[k])
                worst_stat = max(worst_stat, gap / abs(b[k]))
                if gap > GLOO_RTOL * abs(b[k]):
                    raise AssertionError(f"ddp-gloo rank {rank['rank']} step {i + 1} {k}: "
                                         f"{a[k]} against one process {b[k]}")
        for k, v in want.items():
            worst_param = max(worst_param, (got[k] - v).abs().max().item())
            torch.testing.assert_close(got[k], v, rtol=GLOO_RTOL, atol=GLOO_ATOL, msg=k)
    rank_gap = max((params[0][k] - params[1][k]).abs().max().item() for k in want)
    print(f"[ddp-gloo] {GLOO_WORLD} ranks over gloo on one card, {GLOO_ROWS} rows a rank of "
          f"{GLOO_PATCHES} patches, f32: step seconds {[r['step_s'] for r in ranks]} "
          f"(one process {times}); rank peak mem GB {[r['peak_gb'] for r in ranks]} (one "
          f"process {peak:.2f}); stats {ranks[0]['stats']} against one process {stats}: "
          f"worst relative gap {worst_stat}; max|param diff| {worst_param} (rtol "
          f"{GLOO_RTOL}, atol {GLOO_ATOL}); ranks' params apart by {rank_gap}; moments "
          f"launches {[r['launches'] for r in ranks]} card={card}", flush=True)
    return [r["launches"] for r in ranks]


# ---------------------------------------------------------------------------
# the ResNet tower and visual features (phase 18)
# ---------------------------------------------------------------------------

RN50_BATCH = 32      # encode_image's timed batch
RN50_TIMED = 10      # timed encode_image calls
GVF_CALLS = 20       # timed get_visual_feature calls a tower


def phase_resnet(card: str):
    """Phase 18: an RN50-shaped CLIP (``resnet_clip_state_dict`` seed 0,
    loaded by ``convert.from_openai_state_dict``): ``encode_image`` on the
    card in f32 and bf16 against f32 on the CPU at B = 4, images/s at
    B = RN50_BATCH bf16; then ``get_visual_feature`` on the seeded 480x640
    image for ViT-B/32 (random weights, seed 0) and RN50: f32 on the card
    against the CPU, bf16 ms a call and K1 launches (12 a ViT call, through
    ``fused_mha``; none for RN50). Tolerances: f32 within 5e-4 of the
    features' largest magnitude; bf16 within 3x the CPU's own bf16-vs-f32
    move of the same tower (max over the features). -> K1 launches of the
    timed ViT calls."""
    import copy

    import torch

    from semantic_abstraction_tpu_torch.clip import VIT_B_32, ClipSaliency, init_clip_params
    from semantic_abstraction_tpu_torch.clip.convert import from_openai_state_dict
    from semantic_abstraction_tpu_torch.clip.model import encode_image
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    t0 = time.perf_counter()
    rn_cpu, cfg = from_openai_state_dict(resnet_clip_state_dict(0, **RN50), device="cpu")
    vit_cpu = init_clip_params(0, VIT_B_32, device="cpu")
    rn_card, vit_card = copy.deepcopy(rn_cpu).cuda(), copy.deepcopy(vit_cpu).cuda()
    print(f"[resnet] RN50 ({sum(p.numel() for p in rn_cpu.visual.parameters())} visual "
          f"parameters, {cfg.resnet_layers}, {cfg.vision_heads} heads) and ViT-B/32 built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    def check(label, got, ref32, ref16):
        scale = ref32.abs().max().item()
        err = (got.float().cpu() - ref32).abs().max().item()
        move = None if ref16 is None else (ref16 - ref32).abs().max().item()
        tol = 5e-4 * scale if move is None else 3 * move
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"{label}: max err {err} > {tol} (scale {scale})")
        return err, move

    px = torch.as_tensor(np.random.RandomState(0).randn(4, 3, 224, 224).astype(np.float32))
    with torch.no_grad():
        cpu32 = encode_image(rn_cpu, px, cfg, torch.float32)
        cpu16 = encode_image(rn_cpu, px, cfg, torch.bfloat16).float()
        card32 = encode_image(rn_card, px.cuda(), cfg, torch.float32)
        card16 = encode_image(rn_card, px.cuda(), cfg, torch.bfloat16)
    err32, _ = check("rn50 encode_image f32", card32, cpu32, None)
    err16, move = check("rn50 encode_image bf16", card16, cpu32, cpu16)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = torch.randn(RN50_BATCH, 3, 224, 224, device="cuda", generator=g)
    with torch.no_grad():
        for _ in range(2):
            encode_image(rn_card, batch, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(RN50_TIMED):
            feats = encode_image(rn_card, batch, cfg, torch.bfloat16)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if feats.shape != (RN50_BATCH, 1024) or not torch.isfinite(feats).all():
        raise AssertionError(f"rn50 features {tuple(feats.shape)}")
    print(f"[resnet] RN50 encode_image card vs cpu (B = 4): f32 max err {err32}, bf16 max "
          f"err {err16} (the CPU's bf16 move {move}, max|f| {cpu32.abs().max().item()}); "
          f"bf16 B = {RN50_BATCH}: {RN50_BATCH * RN50_TIMED / wall} images/s, peak mem GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} card={card}", flush=True)

    img = np.random.RandomState(0).randint(0, 255, (480, 640, 3), dtype=np.uint8)
    vit_launches = 0
    for name, cpu_m, card_m, c in (("vit-b/32", vit_cpu, vit_card, VIT_B_32),
                                   ("rn50", rn_cpu, rn_card, cfg)):
        ref32 = ClipSaliency(cpu_m, c, torch.float32).get_visual_feature(img)
        ref16 = ClipSaliency(cpu_m, c, torch.bfloat16).get_visual_feature(img).float()
        err32, _ = check(f"{name} get_visual_feature f32",
                         ClipSaliency(card_m, c, torch.float32).get_visual_feature(img),
                         ref32, None)
        sal = ClipSaliency(card_m, c, torch.bfloat16)
        sal.get_visual_feature(img)
        torch.cuda.synchronize()
        fused_mha.launches = 0
        times = []
        for _ in range(GVF_CALLS):
            t0 = time.perf_counter()
            feats = sal.get_visual_feature(img)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = fused_mha.launches
        err16, move = check(f"{name} get_visual_feature bf16", feats, ref32, ref16)
        want = 12 * GVF_CALLS if name == "vit-b/32" else 0
        if launches != want:
            raise AssertionError(f"{name} get_visual_feature: {launches} K1 launches in "
                                 f"{GVF_CALLS} calls, not {want}")
        if name == "vit-b/32":
            vit_launches = launches
        print(f"[visual-feature] {name} 480x640: {1e3 * sum(times) / GVF_CALLS:.3f} ms a "
              f"call (bf16, min {1e3 * min(times):.3f}); K1 launches {launches} in "
              f"{GVF_CALLS} calls; card vs cpu f32 max err {err32}, bf16 {err16} (the "
              f"CPU's bf16 move {move}, max|f| {ref32.abs().max().item()}) card={card}",
              flush=True)
    return vit_launches


def phase_main(card: str):
    """The image paths at full width through the CLI's entry points,
    untimed (the cells ``vitb32-relevancy-ours`` and
    ``vitl14-relevancy-ours`` time them): ViT-B/32 on one image in bf16 and
    on the same image in f32, then ViT-L/14 (random weights from seed 0,
    bf16) on it behind the extractor the CLI builds. Maps of the image's
    shape, finite and not all zero; as many K1 launches in f32 as in bf16;
    on ViT-L/14, K1 once a head block and K2 once a tail block of each
    gradcam call. -> (K1 launches of the ViT-B/32 image by dtype, the
    ViT-L/14 image's K1 and K2 launches and gradcam calls)."""
    import warnings

    import torch

    from semantic_abstraction_tpu_torch.cli import generate_relevancy as cli
    from semantic_abstraction_tpu_torch.clip import (
        ClipConfig, ClipSaliency, init_clip_params, saliency)
    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha
    from semantic_abstraction_tpu_torch.ops.tail_backward import (
        layer_norm_backward, quick_gelu_backward)

    def check(name, maps):
        if maps.shape != (9, 480, 640) or maps.dtype != torch.float16:
            raise AssertionError(f"{name} maps {tuple(maps.shape)} {maps.dtype}")
        if not torch.isfinite(maps).all() or not (maps != 0).any():
            raise AssertionError(f"{name} maps are not finite or all zero")

    launches = {}
    for dtype in ("bfloat16", "float32"):
        args = cli.parser().parse_args(
            ["image", "--random-weights", "--compute_dtype", dtype,
             "--labels", *HEADLINE_LABELS])
        t0 = time.perf_counter()
        sal = cli.build_saliency(args)
        img = np.random.RandomState(args.seed).randint(0, 255, (480, 640, 3), dtype=np.uint8)
        fused_mha.launches = 0
        maps = cli.relevancy(sal, img, args)
        torch.cuda.synchronize()
        launches[dtype] = fused_mha.launches
        del sal
        check(dtype, maps)
        print(f"[main] {dtype} image: weights and the image in "
              f"{time.perf_counter() - t0:.1f} s, fused_mha launches {launches[dtype]} "
              f"card={card}", flush=True)
    if launches["bfloat16"] <= 0 or launches["float32"] != launches["bfloat16"]:
        raise AssertionError(f"fused_mha launches an image by dtype: {launches}")
    torch.cuda.empty_cache()

    args = cli.parser().parse_args(["image", "--random-weights", "--labels", *HEADLINE_LABELS])
    cfg = ClipConfig(**VIT_L_14)
    t0 = time.perf_counter()
    # what build_saliency does with a --clip-ckpt of this shape
    sal = ClipSaliency(init_clip_params(0, cfg, device="cuda"), cfg,
                       compute_dtype=torch.bfloat16, tile_batch_size=args.tile_batch_size)
    n_tail = cfg.vision_layers - sal.num_layers - 1
    img = np.random.RandomState(args.seed).randint(0, 255, (480, 640, 3), dtype=np.uint8)
    calls = 0
    gradcam = saliency.gradcam

    def counted(*a, **kw):
        nonlocal calls
        calls += 1
        return gradcam(*a, **kw)

    # the batched backward runs under the legacy vmap, which runs an op
    # without a batching rule once a label (the tail_backward ops, by
    # design); its warning of that is off unless turned on
    saliency.gradcam = counted
    kernels = {"fused_mha": fused_mha, "cam_accumulate": cam_accumulate,
               "layer_norm_backward": layer_norm_backward,
               "quick_gelu_backward": quick_gelu_backward}
    for k in kernels.values():
        k.launches = 0
    torch._C._debug_only_display_vmap_fallback_warnings(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            maps = cli.relevancy(sal, img, args)
            torch.cuda.synchronize()
    finally:
        saliency.gradcam = gradcam
        torch._C._debug_only_display_vmap_fallback_warnings(False)
    vitl = {name: k.launches for name, k in kernels.items()}
    vitl["gradcam_calls"] = calls
    del sal
    check("vitl14", maps)
    # the tail's LayerNorms but the first block's ln_1, and its GELUs, once a label
    labels = len(HEADLINE_LABELS)
    per_call = {"fused_mha": cfg.vision_layers - n_tail, "cam_accumulate": n_tail,
                "layer_norm_backward": (2 * n_tail - 1) * labels,
                "quick_gelu_backward": n_tail * labels}
    if n_tail < 2 or calls <= 0 or any(vitl[k] != n * calls for k, n in per_call.items()):
        raise AssertionError(f"vitl14: {n_tail} tail blocks, launches {vitl}, "
                             f"expected {per_call} a gradcam call")
    msgs = sorted({str(w.message)[:110] for w in caught})
    print(f"[main] vitl14 bf16 image: weights and the image in "
          f"{time.perf_counter() - t0:.1f} s, {n_tail} tail blocks, T {cfg.vision_tokens}, "
          f"launches {vitl} ({per_call} a gradcam call); {len(caught)} warnings {msgs} "
          f"card={card}", flush=True)
    return launches, vitl


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-of"]:  # a rank of phase 16 or 17
        return rank_main(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # the port's package, from this checkout
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
    print("[datagen] no phase: THOR datagen (datagen/, cli/generate_thor_data.py) runs on "
          "the host only and needs ai2thor, which is not installed; the CPU tests hold it "
          "to the JAX package's (tests/test_torch_datagen.py)", flush=True)

    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    rows = phase_kernel(card)
    crows = phase_cam(card)
    mrows, brows = phase_moments(card)
    lamb_row = phase_lamb(card)
    trows = phase_tail_backward(card)
    phase_small(card, "small", small_config(), 1, (fused_mha,))
    phase_small(card, "small-multitail", small_config(vision_layers=4, vision_patch_size=14),
                0, (fused_mha, cam_accumulate))
    phase_small_ovssc(card)
    image_launches, vitl_launches = phase_main(card)
    torch.cuda.empty_cache()
    phase_ovssc(card)
    torch.cuda.empty_cache()
    phase_small_nets(card)
    vool_launches, vool_s = phase_vool(card)
    torch.cuda.empty_cache()
    loop = {"ovssc": phase_loop(card, "ovssc"), "vool": phase_loop(card, "vool", 1.0 / vool_s)}
    torch.cuda.empty_cache()
    writer_launches, _ = phase_writer(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        scene = inference_scene(tmp)
        phase_tsdf(card, scene)
        inference = {}
        for task in ("ovssc", "vool"):
            inference[task], _ = phase_inference(card, task, scene, os.path.join(tmp, "vis"))
            torch.cuda.empty_cache()
    ddp_launches, ddp_steps = phase_ddp_loop(card)
    gloo_launches = phase_ddp_gloo(card)
    torch.cuda.empty_cache()
    vf_launches = phase_resnet(card)

    # the kernels line. fused_mha: bf16 at the ViT-B/32 path's dominant
    # chunk (48 rows, T = 50), errors over every bf16 shape of the two
    # relevancy paths (relative to max |out|), launches of phase 4's ViT-B/32
    # image; the time at the ViT-L/14 chunk (T = 257) and the launches of
    # phase 4's ViT-L/14 image under "vit_l14". cam_accumulate: bf16 at the
    # ViT-L/14 chunk (L = 9, B = 48, H = 16, T = 257), errors over its bf16
    # shapes (relative to |R| + |cam| @ |R|, tolerance 1e-5), launches of
    # phase 4's ViT-L/14 image; no single PyTorch call computes it. channel_moments:
    # bf16 at level 0 (4, 16, 128^3), errors over the 22 bf16 UNet shapes at
    # B = 4 and 8 (relative to the sum of |x| for s1 and to s2, tolerance
    # 1e-5; the absolute error is one of sums near 1e7); under "vool" the
    # VOOL path's launches with the time at its level-0 shape (8, 16,
    # 128^3). Its "backward" entry: the backward kernel likewise (bit-equal
    # to its plain version, so max_abs_err 0; the library call is one
    # torch.addcmul into a tensor of x's dtype).
    def pick(rs, **kw):
        return next(r for r in rs if all(r[k] == v for k, v in kw.items()))

    def timing(r):
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    main = pick(rows, dtype="bfloat16", B=48, T=50)
    vf = pick(rows, dtype="bfloat16", B=1, T=50)
    minf = pick(mrows, dtype="bfloat16", B=1, S=128**3)
    minf_bf16 = [r for r in mrows if r["dtype"] == "bfloat16" and r["B"] == 1]
    vitl = pick(rows, dtype="bfloat16", B=48, T=257)
    f32_main = pick(rows, dtype="float32", B=48, T=50)
    f32_rows = [r for r in rows if r["dtype"] == "float32"]
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
        "launches": image_launches["bfloat16"],
        "max_abs_err": max(r["max_abs_err"] for r in path_rows),
        "max_rel_err": max(r["max_rel_err"] for r in path_rows),
        **timing(main),
        "vit_l14": {"launches": vitl_launches["fused_mha"],
                    "per_call": vitl_launches["fused_mha"] / vitl_launches["gradcam_calls"],
                    **timing(vitl)},
        # the writer's pipelined scenes and each inference run's relevancy
        "writer": {"launches": writer_launches,
                   "per_scene": writer_launches / WRITER_SCENES},
        "ovssc_inference": {"launches": inference["ovssc"]["fused_mha"]},
        "vool_inference": {"launches": inference["vool"]["fused_mha"]},
        # get_visual_feature at ViT-B/32 (phase 18): one image, B = 1, T = 50
        "visual_feature": {"launches": vf_launches, "per_call": vf_launches / GVF_CALLS,
                           "max_abs_err": vf["max_abs_err"], **timing(vf)},
        # the f32 body: launches of phase 4's f32 ViT-B/32 image, errors
        # over phase 2's ten f32 shapes, the time at the dominant chunk (48, 50)
        "float32": {"launches": image_launches["float32"],
                    "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
                    "max_rel_err": max(r["max_rel_err"] for r in f32_rows),
                    **timing(f32_main)},
    }, {
        "name": "cam_accumulate", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/cam_accumulate.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:34",
        "launches": vitl_launches["cam_accumulate"],
        "per_call": vitl_launches["cam_accumulate"] / vitl_launches["gradcam_calls"],
        "max_abs_err": max(r["max_abs_err"] for r in cbf16),
        "max_rel_err": max(r["max_rel_err"] for r in cbf16),
        **timing(cmain),
    }, {
        "name": "channel_moments", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/channel_moments.cu",
        "replaces": "semantic_abstraction_tpu/ops/pallas_kernels.py:239",
        "max_abs_err": max(r["max_abs_err"] for r in mbf16),
        "max_rel_err": max(r["max_rel_err"] for r in mbf16),
        **timing(mmain),
        "vool": {"launches": vool_launches["channel_moments"], **timing(mvool)},
        # the inference paths' B = 1 forward rows: launches of the OVSSC run
        # (4 classes) and the VOOL run (2 descriptions, target and
        # reference), errors over the 11 bf16 rows, the time at (1, 16, 128^3)
        "inference": {
            "ovssc_launches": inference["ovssc"]["channel_moments"],
            "vool_launches": inference["vool"]["channel_moments"],
            "max_abs_err": max(r["max_abs_err"] for r in minf_bf16),
            "max_rel_err": max(r["max_rel_err"] for r in minf_bf16),
            **timing(minf)},
        "backward": {
            "name": "channel_moments_backward", "route": "cuda",
            "source": "semantic_abstraction_tpu_torch/ops/csrc/channel_moments.cu",
            "replaces": "semantic_abstraction_tpu/models/unet3d.py:75",
            "max_abs_err": max(r["max_abs_err"] for r in brows),
            **timing(bmain),
            "vool": {"launches": vool_launches["channel_moments_backward"],
                     **timing(bvool)},
        },
        # the loop of phase 12: the moments launches of both tasks' loader-fed
        # train epochs, the eval half not counted
        "loop": {
            "launches": sum(n["channel_moments"] for n, _ in loop.values()),
            "backward_launches": sum(n["channel_moments_backward"]
                                     for n, _ in loop.values()),
            "steps": {task: n for task, (_, n) in loop.items()},
        },
        # phase 16: the loop under DDP, world size 1 over NCCL, B = 4
        "ddp_nccl": {"launches": ddp_launches["channel_moments"],
                     "backward_launches": ddp_launches["channel_moments_backward"],
                     "steps": ddp_steps},
        # phase 17: each of the 2 gloo ranks' GLOO_STEPS f32 steps at B = 2
        "ddp_gloo": {"launches": [n["channel_moments"] for n in gloo_launches],
                     "backward_launches": [n["channel_moments_backward"]
                                           for n in gloo_launches],
                     "steps": GLOO_STEPS},
    }, {
        # replaces no Pallas kernel: the JAX package leaves optax's clip and
        # LAMB to XLA's fusion. Phase 2's row at SemAbs3DConfig()'s 121
        # leaves (the clip engaged); launches of phase 12's loader-fed train
        # epochs of both tasks
        "name": "lamb_update", "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/lamb_update.cu",
        "replaces": None,
        "launches": sum(n["lamb_update"] for n, _ in loop.values()),
        "launches_per_step": (sum(n["lamb_update"] for n, _ in loop.values())
                              / sum(n for _, n in loop.values())),
        **lamb_row,
    }] + [{
        # replace no Pallas kernel: the JAX package leaves both backward
        # passes to XLA. Phase 2's row at the ViT-L/14 cell's largest chunk
        # (105 tiles) in bf16, errors over its 8 rows (the largest share of
        # the card test's tolerance); launches of phase 4's ViT-L/14 image
        "name": name, "route": "cuda",
        "source": "semantic_abstraction_tpu_torch/ops/csrc/tail_backward.cu",
        "replaces": None,
        "launches": vitl_launches[name],
        "per_call": vitl_launches[name] / vitl_launches["gradcam_calls"],
        "max_tolerance_share": max(r["tolerance_share"] for r in trows
                                   if r["kernel"] == name),
        **timing(pick(trows, kernel=name, dtype="bfloat16", B=max(TAIL_CHUNKS))),
    } for name in ("layer_norm_backward", "quick_gelu_backward")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
