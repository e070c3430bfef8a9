"""Small configs and batches of the five nets, as (JAX, port) pairs, for
the port's parity tests (``tests/test_torch_{vool,metrics,checkpoint}.py``).

Every case is keyed like ``FORWARD_LOSS`` ("task/approach"), with two
variants of SemAbsVOOL: its pointer on the ``additive`` method (the one
with a parameter) and at the paper's 16 UNet channels (JAX's blocked fast
path held off, as in ``tests/test_torch_ovssc.py``). Beside them, the
bf16 helpers of the OVSSC and VOOL bf16 tests: the JAX package's sampler
and linear roundings written in torch, and one step of each package at
bf16 and f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_abstraction_tpu.models import nets as jnets
from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.models import nets as tnets
from semantic_abstraction_tpu_torch.runtime import train as ttrain

TINY = dict(voxel_shape=(16, 16, 16), unet_num_channels=8, unet_f_maps=4,
            unet_num_groups=2, unet_num_levels=3, pts_feat_extractor_hidden_dim=16)
C16 = dict(TINY, unet_num_channels=16, unet_num_groups=4, unet_num_levels=2)
EMBED = 16  # CLIP feature width of the semantic-aware nets
PD = 8      # pointing dim of the VOOL nets
OPT = dict(lr=1e-2, num_warmup_steps=1, num_training_steps=50)


@dataclasses.dataclass(frozen=True)
class Case:
    key: str             # FORWARD_LOSS key
    jcfg: object
    tcfg: object
    jinit: object        # JAX init(key, cfg)

    @property
    def task(self):
        return self.key.split("/")[0]

    @property
    def approach(self):
        return self.key.split("/")[1]

    def jax_params(self, seed=0):
        return jax.tree_util.tree_map(
            np.asarray, self.jinit(jax.random.PRNGKey(seed), self.jcfg))

    def jax_loss(self):
        return jtrain.FORWARD_LOSS[self.key]

    def torch_loss(self):
        return ttrain.FORWARD_LOSS[self.key]


def _completion(mod, **kw):
    jkw = dict(kw, blocked_basis=False) if mod is jnets else kw
    return mod.SemAbs3DConfig(**jkw)


def _pair(make):
    return make(jnets), make(tnets)


def _case(key, make, jinit):
    jcfg, tcfg = _pair(make)
    return Case(key, jcfg, tcfg, jinit)


CASES = {
    "ovssc/semantic_abstraction": _case(
        "ovssc/semantic_abstraction", lambda m: _completion(m, **TINY),
        jnets.init_semabs3d),
    "ovssc/semantic_aware": _case(
        "ovssc/semantic_aware",
        lambda m: m.SemanticAwareOVSSCConfig(
            completion=_completion(m, **TINY, network_inputs=("rgb",), output_dim=EMBED),
            clip_hidden_dim=EMBED),
        jnets.init_semantic_aware_ovssc),
    "vool/semantic_abstraction": _case(
        "vool/semantic_abstraction",
        lambda m: m.SemAbsVOOLConfig(
            completion=_completion(m, **TINY, decoder_concat_xyz_pts=False),
            pointing_dim=PD),
        jnets.init_semabs_vool),
    "vool/semantic_aware": _case(
        "vool/semantic_aware",
        lambda m: m.SemanticAwareVOOLConfig(
            completion=_completion(m, **TINY, network_inputs=("rgb",), output_dim=PD,
                                   decoder_concat_xyz_pts=False),
            pointing_dim=PD, clip_hidden_dim=EMBED),
        jnets.init_semantic_aware_vool),
    "vool/clip_spatial": _case(
        "vool/clip_spatial",
        lambda m: m.ClipSpatialVOOLConfig(
            completion=_completion(m, **TINY, decoder_concat_xyz_pts=False)),
        jnets.init_clip_spatial_vool),
}
VARIANTS = {
    "vool/semantic_abstraction-additive": dataclasses.replace(
        CASES["vool/semantic_abstraction"],
        **dict(zip(("jcfg", "tcfg"), _pair(lambda m: m.SemAbsVOOLConfig(
            completion=_completion(m, **TINY, decoder_concat_xyz_pts=False),
            pointing_dim=PD, pointing_method="additive"))))),
    "vool/semantic_abstraction-c16": dataclasses.replace(
        CASES["vool/semantic_abstraction"],
        **dict(zip(("jcfg", "tcfg"), _pair(lambda m: m.SemAbsVOOLConfig(
            completion=_completion(m, **C16, decoder_concat_xyz_pts=False),
            pointing_dim=PD))))),
}
ALL_CASES = {**CASES, **VARIANTS}
NEW_NETS = [k for k in CASES if k != "ovssc/semantic_abstraction"]


def batch(case: Case, rs: np.random.RandomState, b=1, d=2, n=64, m=128):
    """Numpy inputs of ``case``'s forward-loss: points over and past the
    scene bounds, 10% of the query points out of bounds, relation ids
    over the whole table ([pad] included)."""
    out = {
        "input_xyz_pts": rs.uniform(-1, 1.9, (b, n, 3)).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1.2, 2.1, (b, d, m, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (b, d, m)).astype(np.float32),
        "out_of_bounds_pts": rs.rand(b, d, m) < 0.1,
        "padding_mask": np.zeros((b, d), np.bool_),
    }

    def feats(f):
        return rs.randn(b, d, n, f).astype(np.float32)

    if case.task == "ovssc":
        out["out_of_frustum_pts_mask"] = rs.rand(b, d, m) < 0.05
    if case.key == "ovssc/semantic_abstraction":
        out["input_feature_pts"] = feats(1)
    elif case.key == "ovssc/semantic_aware":
        out["input_feature_pts"] = feats(3)
        out["semantic_class_features"] = rs.randn(b, d, EMBED).astype(np.float32)
    elif case.approach == "semantic_abstraction":
        out["input_target_saliency_pts"] = feats(1)
        out["input_reference_saliency_pts"] = feats(1)
    elif case.approach == "semantic_aware":
        out["input_rgb_pts"] = feats(3)
        out["target_obj_features"] = rs.randn(b, d, EMBED).astype(np.float32)
        out["reference_obj_features"] = rs.randn(b, d, EMBED).astype(np.float32)
    else:
        out["input_description_saliency_pts"] = feats(1)
    if case.task == "vool":
        out["spatial_relation_id"] = rs.randint(0, len(tnets.RELATIONS), (b, d)).astype(np.int32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _forward_inputs(case, b):
    """The forward's positional inputs, as the forward-loss passes them."""
    names = {
        "ovssc/semantic_abstraction": ("input_xyz_pts", "input_feature_pts",
                                       "output_xyz_pts"),
        "ovssc/semantic_aware": ("input_xyz_pts", "input_feature_pts", "output_xyz_pts",
                                 "semantic_class_features"),
        "vool/semantic_abstraction": ("input_xyz_pts", "input_target_saliency_pts",
                                      "input_reference_saliency_pts", "output_xyz_pts",
                                      "spatial_relation_id"),
        "vool/semantic_aware": ("input_xyz_pts", "input_rgb_pts", "output_xyz_pts",
                                "spatial_relation_id", "target_obj_features",
                                "reference_obj_features"),
        "vool/clip_spatial": ("input_xyz_pts", "input_description_saliency_pts",
                              "output_xyz_pts"),
    }[case.key]
    return [b[k] for k in names]


# the forward's name, the same in both packages
FORWARDS = {
    "ovssc/semantic_abstraction": "semabs3d_forward",
    "ovssc/semantic_aware": "semantic_aware_ovssc_forward",
    "vool/semantic_abstraction": "semabs_vool_forward",
    "vool/semantic_aware": "semantic_aware_vool_forward",
    "vool/clip_spatial": "clip_spatial_vool_forward",
}


def jax_forward(case, params, b):
    fn = getattr(jnets, FORWARDS[case.key])
    return np.asarray(jax.jit(lambda p, xs: fn(p, case.jcfg, *xs))(
        params, [jnp.asarray(x) for x in _forward_inputs(case, b)]))


def torch_forward(case, model, b):
    fn = getattr(tnets, FORWARDS[case.key])
    with torch.no_grad():
        return fn(model, case.tcfg, *(torch.as_tensor(x) for x in _forward_inputs(case, b)))


# ---------------------------------------------------------------------------
# bf16: the JAX package's roundings, and one step of each package
# ---------------------------------------------------------------------------


def corners(vol, coords):
    """The 8 corner values (B, N, 8, C) of each sample of a (B, C, D, H, W)
    volume and their f32 trilinear weights (B, N, 8), corners in (dz, dy,
    dx) order, by the JAX sampler's index math (border clamp,
    align_corners=True, coords[..., 0] indexing W)."""
    b, c, d, h, w = vol.shape
    top = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32)
    idx = torch.minimum(((coords + 1.0) * 0.5 * top).clamp_min(0.0), top)
    lo = torch.minimum(torch.floor(idx), top)
    frac = idx - lo
    lo = lo.long()
    hi = torch.minimum(lo + 1, top.long())
    flat = vol.reshape(b, c, -1)
    vals, weights = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                x, y, z = ((hi if up else lo)[..., i] for i, up in enumerate((dx, dy, dz)))
                lin = ((z * h + y) * w + x)[:, None].expand(b, c, -1)
                vals.append(torch.gather(flat, 2, lin).transpose(1, 2))
                fx, fy, fz = (f if up else 1 - f
                              for f, up in zip(frac.unbind(-1), (dx, dy, dz)))
                weights.append(fz * fy * fx)
    return torch.stack(vals, 2), torch.stack(weights, -1)


def jax_rounding_sampler(vol, coords):
    """The JAX package's bf16 sampler rounding: the weights rounded to the
    volume's dtype, products and sum in f32, one rounding."""
    vals, weights = corners(vol, coords.float())
    return (vals.float() * weights.to(vol.dtype).float()[..., None]).sum(2).to(vol.dtype)


def jax_rounding_linear(p, x):
    """The JAX package's ``_linear``: x @ w rounded, then + b rounded."""
    return torch.matmul(x, p.weight.to(x.dtype).t()) + p.bias.to(x.dtype)


def bf16_and_f32_runs(case, params, b):
    """One train step and the eval step of each package at bf16 and at f32
    from the same weights -> {(package, dtype): (stats as floats, logits)}."""
    out = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", jnp.float32, torch.float32)):
        jtx = jtrain.make_optimizer(**OPT)
        _, js = jtrain.make_train_step(case.jax_loss(), case.jcfg, jtx, compute_dtype=jdt,
                                       donate=False)(
            jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx),
            to_jax(b))
        jl = jtrain.make_eval_step(case.jax_loss(), case.jcfg, compute_dtype=jdt)(
            jax.tree_util.tree_map(jnp.asarray, params), to_jax(b))["logits"]
        ttx = ttrain.make_optimizer(**OPT)
        _, ts = ttrain.make_train_step(case.torch_loss(), case.tcfg, ttx, compute_dtype=tdt)(
            ttrain.init_train_state(tconv.from_jax_params(params, case.tcfg, device="cpu"),
                                    ttx), to_torch(b))
        tl = ttrain.make_eval_step(case.torch_loss(), case.tcfg, compute_dtype=tdt)(
            tconv.from_jax_params(params, case.tcfg, device="cpu"), to_torch(b))["logits"]
        out["jax", name] = ({k: float(v) for k, v in js.items()},
                            np.asarray(jl.astype(jnp.float32)))
        out["port", name] = ({k: float(v) for k, v in ts.items()}, tl.float().numpy())
    return out
