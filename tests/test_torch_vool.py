"""The port's VOOL slice against the JAX package on the CPU: LAMB on
parameters without a gradient, pointing attention, the four nets beside
SemAbs3D (forward, forward-loss, seeded init), three train steps, one bf16
step and the eval step. Weights are carried across by the port's
``from_jax_params``.

Tolerances (f32; the same math with sums in another order):
- LAMB parameters rtol 1e-5, atol 1e-7; pointing attention rtol 1e-5,
  atol 1e-6;
- logits rtol 1e-4, atol 1e-5; loss and accuracy rtol 1e-4;
- loss, accuracy, grad norm per train step rtol 1e-4; every parameter
  after three steps rtol 1e-4, atol 1e-6;
- one bf16 step on three batches: grad norm rtol 2e-3 (OVSSC's bf16
  tolerance), loss rtol 1e-3 (not OVSSC's 2e-5; the reason, and a control
  that shows it, with the tests), accuracy to two points on 0.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.models import decoder as jdec
from semantic_abstraction_tpu.models import nets as jnets
from semantic_abstraction_tpu.models.lamb import lamb as jax_lamb
from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.models import decoder as tdec
from semantic_abstraction_tpu_torch.models import nets as tnets
from semantic_abstraction_tpu_torch.models.lamb import Lamb
from semantic_abstraction_tpu_torch.models.params import Params
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from torch_net_cases import (
    ALL_CASES,
    CASES,
    NEW_NETS,
    batch,
    jax_forward,
    to_jax,
    to_torch,
    torch_forward,
)

OPT = dict(lr=1e-2, num_warmup_steps=1, num_training_steps=50)


def _params_sd(model):
    """The port's parameters in the reference layout (no ``steps``)."""
    return {k: v for k, v in tconv.to_reference_state_dict(model).items()
            if not k.endswith("steps")}


# ---------------------------------------------------------------------------
# LAMB and parameters without a gradient
# ---------------------------------------------------------------------------


def test_lamb_step_treats_a_missing_gradient_as_zero_like_jax():
    """One update where one parameter has no ``.grad``: JAX gives it a
    zero gradient, so its moments decay, its step counts and the weight
    decay moves it by -lr * min(|p|, 10) / |p| * p."""
    rs = np.random.RandomState(0)
    used, unused = rs.randn(6, 5).astype(np.float32), rs.randn(7).astype(np.float32)
    g = rs.randn(6, 5).astype(np.float32)
    tx = jax_lamb(1e-2, weight_decay=1e-2)
    jp = [jnp.asarray(used), jnp.asarray(unused)]
    upd, _ = tx.update([jnp.asarray(g), jnp.zeros(7)], tx.init(jp), jp)
    want = [p + u for p, u in zip(jp, upd)]
    tp = [torch.nn.Parameter(torch.as_tensor(used.copy())),
          torch.nn.Parameter(torch.as_tensor(unused.copy()))]
    tp[0].grad = torch.as_tensor(g)
    opt = Lamb(tp, lr=1e-2, weight_decay=1e-2)
    opt.step()
    assert tp[1].grad is None and opt.state[tp[1]]["step"] == 1
    assert not torch.equal(tp[1].detach(), torch.as_tensor(unused))
    for got, w in zip(tp, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


class _TwoParams(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.used = Params(w=a.shape)
        self.unused = Params(w=b.shape)
        with torch.no_grad():
            self.used.w.copy_(torch.as_tensor(a))
            self.unused.w.copy_(torch.as_tensor(b))


def test_train_step_moves_an_unused_parameter_like_jax():
    """Two ``make_train_step`` steps of a model whose forward reads one of
    its two parameters (as the VOOL nets never read their completion
    decoder), against JAX's ``make_train_step``."""
    rs = np.random.RandomState(1)
    a, bb = rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(np.float32)
    x = rs.randn(8, 4).astype(np.float32)

    def jloss(p, cfg, batch, balance, dtype):
        loss = jnp.mean((batch["x"] @ p["used"]) ** 2)
        return loss, {"accuracy": loss}

    def tloss(model, cfg, batch, balance, dtype):
        loss = ((batch["x"] @ model.used.w) ** 2).mean()
        return loss, {"accuracy": loss}

    jtx = jtrain.make_optimizer(**OPT)
    jstate = jtrain.init_train_state({"used": jnp.asarray(a), "unused": jnp.asarray(bb)}, jtx)
    jstep = jtrain.make_train_step(jloss, None, jtx, donate=False)
    ttx = ttrain.make_optimizer(**OPT)
    tstate = ttrain.init_train_state(_TwoParams(a, bb), ttx)
    tstep = ttrain.make_train_step(tloss, None, ttx)
    for _ in range(2):
        jstate, jstats = jstep(jstate, {"x": jnp.asarray(x)})
        tstate, tstats = tstep(tstate, {"x": torch.as_tensor(x)})
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=1e-5)
    for name in ("used", "unused"):
        np.testing.assert_allclose(getattr(tstate.model, name).w.detach().numpy(),
                                   np.asarray(jstate.params[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# pointing attention
# ---------------------------------------------------------------------------

POINT_SHAPES = {
    "vool": ((4, 10, 8), (4, 1, 8)),      # key (B*D, M, pd), query (B*D, 1, pd)
    "same": ((2, 5, 8), (2, 5, 8)),
    "4d-key": ((2, 3, 5, 8), (2, 4, 8)),
    "paired": ((2, 3, 8), (2, 3, 10, 8)),  # key (B, P, E), query (B, P, M, E)
}


@pytest.mark.parametrize("shapes", list(POINT_SHAPES))
@pytest.mark.parametrize("method", list(tdec.POINTING_METHODS))
def test_pointing_attention_matches_jax(method, shapes):
    """Every method on each broadcast form, with an all-zero key row and
    query row (the cosine's 1e-8 clamp: 0, not NaN)."""
    rs = np.random.RandomState(2)
    kshape, qshape = POINT_SHAPES[shapes]
    key = rs.randn(*kshape).astype(np.float32)
    query = rs.randn(*qshape).astype(np.float32)
    key[0, 0] = 0.0
    query[-1, 0] = 0.0
    jp = jax.tree_util.tree_map(np.asarray, jdec.init_pointing_attention(
        jax.random.PRNGKey(3), 8, method))
    pointer = tdec.PointingAttention(8, method)
    if method == "additive":
        pointer.load_state_dict({"pointer_v.weight": torch.as_tensor(jp["v"].T.copy())})
    jfn, tfn = ((jdec.pointing_attention_paired, tdec.pointing_attention_paired)
                if shapes == "paired" else
                (jdec.pointing_attention, tdec.pointing_attention))
    want = np.asarray(jfn(jp, jnp.asarray(key), jnp.asarray(query), method, 8, 0.07))
    with torch.no_grad():
        got = tfn(pointer, torch.as_tensor(key), torch.as_tensor(query), method, 8,
                  0.07).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if shapes == "vool":
        assert got.shape == (4, 10, 1)


def test_cosine_pointer_on_a_bf16_key_matches_jax():
    """VOOL's bf16 path: a bf16 key (the sampled features) against the f32
    relation rows. The norms round as the JAX package's compiled
    ``jnp.linalg.norm`` rounds them (squares summed in f32, the sum rounded
    to bf16, then its root); ``torch.linalg.vector_norm`` rounds once and
    misses by up to a bf16 ulp of the norm, 0.05 of a logit here."""
    rs = np.random.RandomState(12)
    key = (rs.randn(2, 128, 8) * 0.2).astype(np.float32)
    query = rs.randn(2, 1, 8).astype(np.float32)
    want = np.asarray(jax.jit(lambda k, q: jdec.pointing_attention({}, k, q))(
        jnp.asarray(key).astype(jnp.bfloat16), jnp.asarray(query)))
    got = tdec.pointing_attention(tdec.PointingAttention(8), torch.as_tensor(key).bfloat16(),
                                  torch.as_tensor(query))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_pointing_attention_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        tdec.PointingAttention(8, "bilinear")


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(ALL_CASES))
def test_net_forward_matches_jax(key):
    case = ALL_CASES[key]
    params = case.jax_params()
    model = tconv.from_jax_params(params, case.tcfg, device="cpu")
    b = batch(case, np.random.RandomState(4))
    got = torch_forward(case, model, b)
    want = jax_forward(case, params, b)
    assert got.shape == want.shape == (1, 2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_semantic_aware_vool_reads_its_completion_decoder():
    """The quirk that changes values: SemanticAwareVOOL's logits move with
    its completion decoder (built without xyz concat, fc1 C wide), which
    SemAbsVOOL's forward never reads."""
    case = CASES["vool/semantic_aware"]
    model = tnets.init_net(0, case.tcfg, device="cpu")
    assert model.completion_net.visual_sampler.mlp[0].weight.shape == (8, 8)
    b = batch(case, np.random.RandomState(5))
    before = torch_forward(case, model, b)
    with torch.no_grad():
        model.completion_net.visual_sampler.mlp[2].bias.add_(1.0)
    assert not torch.allclose(before, torch_forward(case, model, b))
    vcase = CASES["vool/semantic_abstraction"]
    vmodel = tnets.init_net(0, vcase.tcfg, device="cpu")
    vb = batch(vcase, np.random.RandomState(5))
    before = torch_forward(vcase, vmodel, vb)
    with torch.no_grad():
        vmodel.completion_net.visual_sampler.mlp[2].bias.add_(1.0)
    torch.testing.assert_close(before, torch_forward(vcase, vmodel, vb), rtol=0, atol=0)


def test_stacked_streams_equal_two_unet_passes():
    """SemAbsVOOL's one UNet pass over the 2D stacked target and reference
    volumes equals a pass over each stream."""
    case = CASES["vool/semantic_abstraction"]
    model = tnets.init_net(1, case.tcfg, device="cpu")
    b = to_torch(batch(case, np.random.RandomState(6)))
    ccfg = case.tcfg.completion
    with torch.no_grad():
        both = tnets.semabs3d_feature_vol(
            model.completion_net, ccfg, b["input_xyz_pts"],
            torch.cat([b["input_target_saliency_pts"], b["input_reference_saliency_pts"]], 1))
        for i, k in enumerate(("input_target_saliency_pts", "input_reference_saliency_pts")):
            one = tnets.semabs3d_feature_vol(model.completion_net, ccfg,
                                             b["input_xyz_pts"], b[k])
            torch.testing.assert_close(both[2 * i:2 * i + 2], one, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", NEW_NETS)
def test_init_net_matches_jax_shapes_and_is_seeded(key):
    case = CASES[key]
    want = tconv.jax_params_to_state_dict(case.jax_params(), case.tcfg)
    a = tconv.to_reference_state_dict(tnets.init_net(11, case.tcfg, device="cpu"))
    b = tconv.to_reference_state_dict(tnets.init_net(11, case.tcfg, device="cpu"))
    c = tconv.to_reference_state_dict(tnets.init_net(12, case.tcfg, device="cpu"))
    assert {k for k in a if not k.endswith("steps")} == set(want)
    for k, v in want.items():
        assert tuple(a[k].shape) == np.shape(v), k
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    assert any(not torch.equal(a[k], c[k]) for k in want)


def test_relation_table_gradient_is_dense_with_zero_rows():
    """The (7, d) table is one parameter indexed by ids: its gradient is a
    full (7, d) tensor, zero on the rows no description uses."""
    case = CASES["vool/semantic_abstraction"]
    model = tnets.init_net(2, case.tcfg, device="cpu")
    b = to_torch(batch(case, np.random.RandomState(7)))
    b["spatial_relation_id"] = torch.tensor([[1, 4]], dtype=torch.int32)
    loss, _ = ttrain.vool_forward_loss(model, case.tcfg, b, compute_dtype=torch.float32)
    loss.backward()
    g = model.relation_embeddings.grad
    assert g.shape == (7, 8)
    used = torch.zeros(7, dtype=torch.bool)
    used[[1, 4]] = True
    assert (g[~used] == 0).all() and (g[used] != 0).any(dim=1).all()
    assert model.completion_net.visual_sampler.mlp[0].weight.grad is None


# ---------------------------------------------------------------------------
# forward-losses, train and eval steps
# ---------------------------------------------------------------------------


def test_forward_loss_table_has_the_five_keys():
    assert set(ttrain.FORWARD_LOSS) == set(jtrain.FORWARD_LOSS) == set(CASES)


@pytest.mark.parametrize("key", list(CASES))
def test_forward_loss_matches_jax(key):
    case = CASES[key]
    params = case.jax_params(1)
    b = batch(case, np.random.RandomState(8))
    b["padding_mask"][0, 1] = True
    jl, jaux = jax.jit(lambda p, bt: case.jax_loss()(p, case.jcfg, bt, True, jnp.float32))(
        params, to_jax(b))
    with torch.no_grad():
        tl, taux = case.torch_loss()(tconv.from_jax_params(params, case.tcfg, device="cpu"),
                                     case.tcfg, to_torch(b), True, torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(taux["accuracy"]), float(jaux["accuracy"]), rtol=1e-4)
    np.testing.assert_array_equal(taux["ignore"].numpy(), np.asarray(jaux["ignore"]))


@pytest.mark.parametrize("key", NEW_NETS)
def test_three_train_steps_match_jax(key):
    """Loss, accuracy and grad norm at each step, then every parameter,
    the VOOL nets' unused completion decoder (``completion_net.
    visual_sampler.*``, moved only by LAMB's weight decay) included."""
    case = CASES[key]
    params = case.jax_params()
    b = batch(case, np.random.RandomState(9))
    jtx = jtrain.make_optimizer(**OPT)
    jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx)
    jstep = jtrain.make_train_step(case.jax_loss(), case.jcfg, jtx,
                                   compute_dtype=jnp.float32, donate=False)
    ttx = ttrain.make_optimizer(**OPT)
    tstate = ttrain.init_train_state(
        tconv.from_jax_params(params, case.tcfg, device="cpu"), ttx)
    tstep = ttrain.make_train_step(case.torch_loss(), case.tcfg, ttx,
                                   compute_dtype=torch.float32)
    jb, tb = to_jax(b), to_torch(b)
    for i in range(3):
        jstate, jstats = jstep(jstate, jb)
        tstate, tstats = tstep(tstate, tb)
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    want = tconv.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), case.tcfg)
    got = _params_sd(tstate.model)
    assert got.keys() == want.keys()
    start = tconv.jax_params_to_state_dict(params, case.tcfg)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, atol=1e-6, err_msg=k)
        if "visual_sampler" in k and case.task == "vool" and case.approach != "semantic_aware":
            assert not np.allclose(v, start[k], rtol=0, atol=0), k  # decayed, unread


# ---------------------------------------------------------------------------
# bf16: where the port rounds other than JAX, and what that does to VOOL
# ---------------------------------------------------------------------------

BF16_SEEDS = (10, 11, 12)


def _corners(vol, coords):
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


def _jax_rounding_sampler(vol, coords):
    """The JAX package's bf16 sampler rounding: the weights rounded to the
    volume's dtype, products and sum in f32, one rounding."""
    vals, weights = _corners(vol, coords.float())
    return (vals.float() * weights.to(vol.dtype).float()[..., None]).sum(2).to(vol.dtype)


def _jax_rounding_linear(p, x):
    """The JAX package's ``_linear``: x @ w rounded, then + b rounded."""
    return torch.matmul(x, p.weight.to(x.dtype).t()) + p.bias.to(x.dtype)


def test_bf16_sampler_differs_from_jax_only_in_its_weight_rounding():
    """On one bf16 volume, JAX's sampler is the trilinear sum with its
    weights rounded to bf16, bit for bit; the port's (torch's
    ``grid_sample`` in f32, as the reference samples) is the same sum with
    f32 weights (to f32 rounding: torch forms the weights in another
    order), rounded once to bf16."""
    from semantic_abstraction_tpu.ops.sampling import grid_sample_3d_cl
    from semantic_abstraction_tpu_torch.ops.sampling import grid_sample_3d

    rs = np.random.RandomState(13)
    vol = torch.as_tensor(rs.randn(2, 16, 16, 16, 16).astype(np.float32) * 0.3).bfloat16()
    coords = torch.as_tensor(rs.uniform(-1.1, 1.1, (2, 500, 3)).astype(np.float32))
    want = jax.jit(grid_sample_3d_cl)(
        jnp.asarray(vol.permute(0, 2, 3, 4, 1).float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(coords.numpy()))
    want = torch.as_tensor(np.array(want.astype(jnp.float32))).bfloat16()
    assert torch.equal(_jax_rounding_sampler(vol, coords), want)
    vals, weights = _corners(vol, coords)
    port32 = grid_sample_3d(vol.float(), coords)
    torch.testing.assert_close(port32, (vals.float() * weights[..., None]).sum(2),
                               rtol=1e-6, atol=1e-7)
    port = grid_sample_3d(vol, coords)
    assert torch.equal(port, port32.bfloat16()) and not torch.equal(port, want)


def _bf16_and_f32_runs(case, params, b):
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


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_bf16_vool_train_step_matches_jax(seed):
    """One SemAbsVOOL step at bf16 compute from the same weights, against
    JAX's bf16 step, on three batches.

    - Grad norm rtol 2e-3 (OVSSC's bf16 tolerance); loss rtol 1e-3, not
      OVSSC's 2e-5: the port rounds its UNet sums, its sampler and its
      linears other than JAX (the control below), and VOOL's logits are
      cosines / 0.07, so a bf16 ulp of a pointer key moves its logit 14
      times as far as at OVSSC's scale. Read over seeds 10-14
      (``scripts/torch_vool_bf16_readings.py``): loss 0.85e-4 to 3.9e-4
      apart, grad norm 0.8e-4 to 1.0e-3. Accuracy may flip up to two
      points that sit on 0.
    - Both ways: the port's bf16 logits move from its f32 logits by 0.5 to
      1.25 times as much as JAX's do from JAX's (mean |diff|, read 0.82 to
      0.95), and lie nearer JAX's bf16 logits than JAX's f32 logits do
      (read 0.67 to 0.78 of that); the bf16 step's grad norm moves from
      f32's by 0.5 to 2 times JAX's move (read 0.54 to 1.63). A port that
      ran f32 whatever the compute dtype fails the first and the last."""
    case = CASES["vool/semantic_abstraction"]
    b = batch(case, np.random.RandomState(seed))
    runs = _bf16_and_f32_runs(case, case.jax_params(), b)
    (port, plog), (jax_, jlog) = runs["port", "bf16"], runs["jax", "bf16"]
    (port32, plog32), (jax32, jlog32) = runs["port", "f32"], runs["jax", "f32"]
    for k, rtol in (("loss", 1e-3), ("grad_norm", 2e-3)):
        np.testing.assert_allclose(port[k], jax_[k], rtol=rtol, err_msg=k)
    counted = (~(b["padding_mask"][..., None] | b["out_of_bounds_pts"])).sum()
    assert abs(port["accuracy"] - jax_["accuracy"]) <= 2 / counted + 1e-7
    jax_drift = np.abs(jlog - jlog32).mean()
    assert 0.5 <= np.abs(plog - plog32).mean() / jax_drift <= 1.25
    assert np.abs(plog - jlog).mean() <= jax_drift
    port_gap = abs(port["grad_norm"] - port32["grad_norm"])
    jax_gap = abs(jax_["grad_norm"] - jax32["grad_norm"])
    assert 0.5 * jax_gap <= port_gap <= 2 * jax_gap, (port_gap, jax_gap)


def bf16_control_runs(seed):
    """SemAbsVOOL's bf16 forward-loss on batch ``seed``: JAX's, the
    port's, and the port's with JAX's roundings (its spatial sampler handed
    the bf16 volume that JAX's sampler got, its sampler weights and linears
    rounded as JAX rounds them) -> {name: (loss, logits)}."""
    case = CASES["vool/semantic_abstraction"]
    params = case.jax_params()
    b = batch(case, np.random.RandomState(seed))
    vols = []
    jax_decoder = jnets.implicit_decoder

    def capture(p, vol, *args, **kw):
        vols.append(vol)
        return jax_decoder(p, vol, *args, **kw)

    with mock.patch.object(jnets, "implicit_decoder", capture):
        jl, jaux = case.jax_loss()(params, case.jcfg, to_jax(b), False, jnp.bfloat16)
    out = {"jax": (float(jl), np.asarray(jaux["logits"].astype(jnp.float32)))}
    jax_vol = torch.as_tensor(np.array(jnp.concatenate(vols).astype(jnp.float32)))
    jax_vol = jax_vol.permute(0, 4, 1, 2, 3).bfloat16()  # JAX's is channel-last

    def run():
        with torch.no_grad():
            loss, aux = case.torch_loss()(
                tconv.from_jax_params(params, case.tcfg, device="cpu"), case.tcfg,
                to_torch(b), False, torch.bfloat16)
        return float(loss), aux["logits"].float().numpy()

    out["port"] = run()
    port_decoder = tnets.implicit_decoder
    with mock.patch.object(tnets, "implicit_decoder",
                           lambda dec, vol, *a, **kw: port_decoder(dec, jax_vol, *a, **kw)), \
            mock.patch.object(tdec, "grid_sample_3d", _jax_rounding_sampler), \
            mock.patch.object(tdec, "linear", _jax_rounding_linear):
        out["port, JAX's roundings"] = run()
    return out


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_bf16_vool_logit_gap_is_where_the_port_rounds(seed):
    """The control for the loss tolerance above. With JAX's roundings in
    the port (``bf16_control_runs``), its bf16 logits come within 1/20 of
    their gap to JAX's (read 1/72 to 1/776 over seeds 10-14, 96.5-98.4% of
    them bit for bit) and its loss within rtol 5e-5 (read 1.1e-6 to
    2.7e-5, against 0.85e-4 to 3.9e-4 without; the same script)."""
    runs = bf16_control_runs(seed)
    jl, jlog = runs["jax"]
    (loss, logits), (ctrl_loss, ctrl_logits) = runs["port"], runs["port, JAX's roundings"]
    gap, ctrl_gap = np.abs(logits - jlog).mean(), np.abs(ctrl_logits - jlog).mean()
    assert ctrl_gap <= gap / 20, (ctrl_gap, gap)
    np.testing.assert_allclose(ctrl_loss, jl, rtol=5e-5)
    assert abs(ctrl_loss - jl) < abs(loss - jl)


@pytest.mark.parametrize("key", NEW_NETS)
def test_eval_step_matches_jax(key):
    """Two samples, the second's last description padded."""
    case = CASES[key]
    params = case.jax_params(2)
    b = batch(case, np.random.RandomState(11), b=2)
    b["padding_mask"][1, 1] = True
    want = jtrain.make_eval_step(case.jax_loss(), case.jcfg, compute_dtype=jnp.float32)(
        jax.tree_util.tree_map(jnp.asarray, params), to_jax(b))
    got = ttrain.make_eval_step(case.torch_loss(), case.tcfg, compute_dtype=torch.float32)(
        tconv.from_jax_params(params, case.tcfg, device="cpu"), to_torch(b))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
