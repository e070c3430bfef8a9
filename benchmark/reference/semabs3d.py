"""Plain PyTorch reference of the OVSSC SemAbs3D train step, in float32.

The net (real-stanford/semantic-abstraction net.py SemAbs3D, with the
pytorch-3dunet ResidualUNet3D and the implicit decoder), its loss
(train_ovssc.py: BCE with logits, mean over the points not ignored), the
clip to global norm and the reference's vendored LAMB (arm/optim/lamb.py)
on HF's linear warm-up, written from those sources over a state dict in
the reference layout. It imports nothing of the program.

``precision`` is "float32" (the reference) or "fp8" (the control, fp8
training as on Hopper: every matmul and convolution operand rounded to
float8 e4m3 and every gradient into their outputs to e5m2, each under a
per-tensor scale: the step below the bfloat16 the configuration states).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x with each element rounded to ``dtype`` under a per-tensor scale."""
    scale = FP8_MAX[dtype] / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3; the gradient passes straight through."""
    return x + (_round(x.detach(), torch.float8_e4m3fn) - x.detach())


class _GradE5M2(torch.autograd.Function):
    """The identity, whose gradient is rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def operand_rounding(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"unknown precision {precision!r}")


def gradient_rounding(precision: str):
    return (lambda x: x) if precision == "float32" else _GradE5M2.apply


def _linear(q, x, sd, key):
    return q.grad(F.linear(q(x), q(sd[key + ".weight"]), sd[key + ".bias"]))


class Rounding:
    """``q(x)``: a forward operand's rounding; ``q.grad(y)``: the rounding
    of the gradient into an output."""

    def __init__(self, precision: str):
        self.operand = operand_rounding(precision)
        self.grad = gradient_rounding(precision)

    def __call__(self, x):
        return self.operand(x)


def _group_norm(x, w, b, groups):
    c = x.shape[1]
    return F.group_norm(x, groups if c >= groups else 1, w, b, eps=1e-5)


def _block(q, x, sd, prefix, groups):
    """ExtResNetBlock, layer order "gcr": GroupNorm -> Conv3d (no bias) ->
    ReLU, conv3 without the ReLU, the residual added before the last ReLU."""
    outs = []
    for j in (1, 2, 3):
        p = f"{prefix}.basic_module.conv{j}."
        h = _group_norm(x, sd[p + "groupnorm.weight"], sd[p + "groupnorm.bias"], groups)
        h = q.grad(F.conv3d(q(h), q(sd[p + "conv.weight"]), padding=1))
        x = torch.relu(h) if j < 3 else h
        outs.append(x)
    return torch.relu(outs[2] + outs[0])


def unet3d(q, x, sd, c):
    u = "vol_feature_extractor"
    skips = []
    for i in range(c["unet_num_levels"]):
        if i > 0:
            x = F.max_pool3d(x, 2)
        x = _block(q, x, sd, f"{u}.encoders.{i}", c["unet_num_groups"])
        skips.insert(0, x)
    for i, skip in enumerate(skips[1:]):
        p = f"{u}.decoders.{i}"
        x = q.grad(F.conv_transpose3d(q(x), q(sd[p + ".upsampling.upsample.weight"]),
                                      sd[p + ".upsampling.upsample.bias"], stride=2,
                                      padding=1, output_padding=1))
        x = _block(q, x + skip, sd, p, c["unet_num_groups"])
    return q.grad(F.conv3d(q(x), q(sd[u + ".final_conv.weight"]), sd[u + ".final_conv.bias"]))


def _voxel_index(xyz, c):
    """World points -> float voxel index (x, y, z) over the scene bounds."""
    lower = torch.tensor(c["scene_bounds"][0], dtype=xyz.dtype, device=xyz.device)
    upper = torch.tensor(c["scene_bounds"][1], dtype=xyz.dtype, device=xyz.device)
    top = torch.tensor(c["voxel_shape"], dtype=xyz.dtype, device=xyz.device) - 1
    return (xyz - lower) * (top / (upper - lower)), top


def forward_logits(sd: Dict[str, torch.Tensor], c: dict, batch: Dict[str, torch.Tensor],
                   precision: str = "float32") -> torch.Tensor:
    """(B, P, M) logits: the point MLP on (xyz, saliency), the mean of each
    voxel's point features (empty voxels 0), the UNet, and the decoder MLP
    on the volume sampled trilinearly at each query point (index
    normalized by the grid shape, world x on the volume's last axis)."""
    q = Rounding(precision)
    xyz_in, feats = batch["input_xyz_pts"].float(), batch["input_feature_pts"].float()
    b, p, n, f = feats.shape
    xyz = xyz_in[:, None].expand(b, p, n, 3).reshape(b * p, n, 3)
    h = torch.cat([xyz, feats.reshape(b * p, n, f)], -1)
    h = F.leaky_relu(_linear(q, h, sd, "pts_feat_extractor.0"), 0.01)
    h = F.leaky_relu(_linear(q, h, sd, "pts_feat_extractor.2"), 0.01)
    h = _linear(q, h, sd, "pts_feat_extractor.4")  # (BP, N, C)
    gx, gy, gz = c["voxel_shape"]
    idx_f, top = _voxel_index(xyz, c)
    idx = torch.minimum(torch.trunc(idx_f).long().clamp_min(0), top.long())
    flat = idx[..., 0] * (gy * gz) + idx[..., 1] * gz + idx[..., 2]
    flat = flat + torch.arange(b * p, device=flat.device)[:, None] * (gx * gy * gz)
    ch = h.shape[-1]
    sums = h.new_zeros((b * p * gx * gy * gz, ch)).index_add(0, flat.reshape(-1),
                                                            h.reshape(-1, ch))
    count = h.new_zeros(b * p * gx * gy * gz).index_add(
        0, flat.reshape(-1), torch.ones_like(flat.reshape(-1), dtype=h.dtype))
    vol = (sums / count.clamp_min(1.0)[:, None]).reshape(b * p, gx, gy, gz, ch)
    vol = unet3d(q, vol.permute(0, 4, 1, 2, 3).contiguous(), sd, c)
    qxyz = batch["output_xyz_pts"].float()
    m = qxyz.shape[2]
    qi, top = _voxel_index(qxyz.reshape(b * p, m, 3), c)
    shape = torch.tensor(c["voxel_shape"], dtype=qi.dtype, device=qi.device)
    coords = 2.0 * (torch.minimum(qi.clamp_min(0.0), top) / shape) - 1.0
    sampled = F.grid_sample(vol, coords.reshape(b * p, m, 1, 1, 3), mode="bilinear",
                            padding_mode="border", align_corners=True)
    sampled = sampled.reshape(b * p, ch, m).transpose(1, 2)
    if c["decoder_concat_xyz_pts"]:
        sampled = torch.cat([sampled, coords], -1)
    h = F.leaky_relu(_linear(q, sampled, sd, "visual_sampler.mlp.0"), 0.01)
    return _linear(q, h, sd, "visual_sampler.mlp.2")[..., 0].reshape(b, p, m)


def loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """BCE with logits, mean over the points neither padded, out of bounds
    nor out of the frustum."""
    y = batch["output_label_pts"].float()
    ignore = batch["padding_mask"].bool()[..., None] | batch["out_of_bounds_pts"].bool()
    if "out_of_frustum_pts_mask" in batch:
        ignore = ignore | batch["out_of_frustum_pts_mask"].bool()
    keep = (~ignore).float()
    bce = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    return (bce * keep).sum() / keep.sum().clamp_min(1.0)


class Lamb:
    """The reference's LAMB: no debiasing, weight decay inside the trust
    ratio's numerator, the weight norm clamped to [0, 10], trust 1 where
    either norm is 0; the learning rate lr x warm-up(t) of the t-th step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 warmup: int, betas=(0.9, 0.999), eps: float = 1e-6):
        self.lr, self.wd, self.warmup, self.betas, self.eps = lr, weight_decay, warmup, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def schedule(self, t: int) -> float:
        """HF ``cosine_with_restarts`` inside its warm-up (every compared
        step is one)."""
        if t >= self.warmup:
            raise ValueError("the reference follows warm-up steps only")
        return t / max(1.0, self.warmup)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        lr = self.lr * self.schedule(self.t)
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            step = self.m[k] / (self.v[k].sqrt() + self.eps) + self.wd * p
            wn = p.norm().clamp(0.0, 10.0)
            an = step.norm()
            trust = 1.0 if float(wn) == 0.0 or float(an) == 0.0 else float(wn / an)
            p.sub_(lr * trust * step)


def train_steps(sd: Dict[str, torch.Tensor], c: dict, recipe: dict,
                batches: List[Dict[str, torch.Tensor]], precision: str = "float32"):
    """Follow ``len(batches)`` steps from the weights ``sd`` -> (losses, the
    first step's clipped gradient by leaf, the parameters after the last
    step by leaf). Float32 with TF32 off unless ``precision`` says fp8."""
    params = {k: v.detach().clone().float() for k, v in sd.items() if k != "steps"}
    opt = Lamb(params, recipe["lr"], recipe["weight_decay"], recipe["num_warmup_steps"])
    losses, first_grad = [], None
    for batch in batches:
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        lv = loss(forward_logits(live, c, batch, precision), batch)
        grads = dict(zip(live, torch.autograd.grad(lv, list(live.values()))))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        scale = 1.0 if float(norm) < recipe["grad_max_norm"] else \
            recipe["grad_max_norm"] / float(norm)
        grads = {k: g * scale for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(lv.detach()))
    return losses, first_grad, params


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's."""
    ref_norms = {k: float(ref[k].double().norm()) for k in keys}
    median = sorted(ref_norms.values())[len(keys) // 2]
    return [abs(float(prog[k].double().norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
            for k in keys]


def leaf_gap(prog, ref, keys) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref, keys))


def median_leaf_gap(prog, ref, keys) -> float:
    """The median leaf's gap: the first gradient's number. The worst leaf's
    is bf16 rounding amplified where a GroupNorm affine's gradient is the
    small remainder of a sum over a million voxels (PERF.md)."""
    gaps = sorted(leaf_gaps(prog, ref, keys))
    return gaps[len(gaps) // 2]


def moving_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's norm: the others (a bias that a GroupNorm cancels) move by
    round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in first_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(k for k, v in norms.items() if v > 1e-3 * median)


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if hasattr(torch, "set_float32_matmul_precision"):
        torch.set_float32_matmul_precision("highest")


def worst_relative(a: List[float], b: List[float]) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)) if a else math.inf
