"""The port's OVSSC slice against the JAX package on the CPU: the sampler,
the implicit decoder, SemAbs3D's forward, the loss, LAMB, the schedules,
three train steps, the eval step and the reference state-dict loader.
Weights are carried across by the port's ``from_jax_params``.

Tolerances (f32; the same math with sums in another order):
- sampler values and volume gradient, decoder values atol=rtol=1e-5;
  forward logits and the feature volume atol=rtol=1e-4;
- losses rtol=1e-5, atol=1e-6; LAMB parameters rtol=1e-5, atol=1e-7;
- loss, accuracy, grad norm per train step rtol=1e-4; parameters after
  three steps rtol=1e-4, atol=1e-6;
- schedules rtol=1e-6 (JAX computes them in f32, the port in float64).

The bf16 forward and train step have their own tolerances, stated in
their tests.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.models import decoder as jdec
from semantic_abstraction_tpu.models import nets as jnets
from semantic_abstraction_tpu.models.convert import convert_semabs3d_state_dict
from semantic_abstraction_tpu.models.lamb import lamb as jax_lamb
from semantic_abstraction_tpu.ops.sampling import grid_sample_3d as jax_grid_sample
from semantic_abstraction_tpu.ops.voxel import VoxelGrid as JaxGrid
from semantic_abstraction_tpu.runtime import losses as jlosses
from semantic_abstraction_tpu.runtime import schedule as jsched
from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.models import decoder as tdec
from semantic_abstraction_tpu_torch.models import nets as tnets
from semantic_abstraction_tpu_torch.models.lamb import Lamb
from semantic_abstraction_tpu_torch.ops.sampling import grid_sample_3d
from semantic_abstraction_tpu_torch.ops.voxel import VoxelGrid
from semantic_abstraction_tpu_torch.runtime import losses as tlosses
from semantic_abstraction_tpu_torch.runtime import schedule as tsched
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from torch_net_cases import (
    CASES,
    bf16_and_f32_runs,
    jax_rounding_linear,
    jax_rounding_sampler,
)

TINY = dict(voxel_shape=(16, 16, 16), unet_num_channels=8, unet_f_maps=4,
            unet_num_groups=2, unet_num_levels=3, pts_feat_extractor_hidden_dim=16)
# the paper's 16 UNet channels (JAX's blocked fast path, held off)
C16 = dict(voxel_shape=(16, 16, 16), unet_num_channels=16, unet_f_maps=4,
           unet_num_groups=4, unet_num_levels=2, pts_feat_extractor_hidden_dim=16)


def _cfgs(**kw):
    jkw = dict(kw, blocked_basis=False) if kw.get("unet_num_channels") == 16 else kw
    return jnets.SemAbs3DConfig(**jkw), tnets.SemAbs3DConfig(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rs, b, p=2, n=64, q=None, m=128):
    q = p if q is None else q
    out_of_bounds = rs.rand(b, q, m) < 0.1
    return {
        "input_xyz_pts": rs.uniform(-1, 1.9, (b, n, 3)).astype(np.float32),
        "input_feature_pts": rs.randn(b, p, n, 1).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1.2, 2.1, (b, q, m, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (b, q, m)).astype(np.float32),
        "out_of_bounds_pts": out_of_bounds,
        "out_of_frustum_pts_mask": np.zeros((b, q, m), np.bool_),
        "padding_mask": np.zeros((b, q), np.bool_),
    }


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# sampler and decoder
# ---------------------------------------------------------------------------


def _coords(rs, b, n):
    coords = rs.uniform(-1.3, 1.3, (b, n, 3)).astype(np.float32)
    # exact corners and faces, and points past them (border padding)
    coords[:, :6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.5], [-1.2, 1.0, 1.1],
                     [0.999, 1.0, -1.0], [0.0, 0.0, 0.0]]
    return coords


def test_grid_sample_values_and_volume_gradient_match_jax():
    rs = np.random.RandomState(0)
    vol = rs.randn(2, 3, 5, 6, 7).astype(np.float32)
    coords = _coords(rs, 2, 200)
    w = rs.randn(2, 200, 3).astype(np.float32)
    want = jax_grid_sample(jnp.asarray(vol), jnp.asarray(coords))
    jgrad = jax.grad(lambda v: jnp.sum(jax_grid_sample(v, jnp.asarray(coords)) * w))(
        jnp.asarray(vol))
    vt = torch.as_tensor(vol).requires_grad_()
    got = grid_sample_3d(vt, torch.as_tensor(coords))
    assert got.shape == (2, 200, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jgrad), atol=1e-5,
                               rtol=1e-5)


def test_grid_sample_of_bf16_volume_samples_in_f32():
    """A bf16 volume is sampled with f32 coords and fractions, then
    rounded: equal to sampling its f32 copy, rounded to bf16."""
    rs = np.random.RandomState(1)
    vol = torch.as_tensor(rs.randn(1, 4, 64, 64, 64).astype(np.float32)).bfloat16()
    coords = torch.as_tensor(_coords(rs, 1, 300))
    got = grid_sample_3d(vol, coords)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, grid_sample_3d(vol.float(), coords).bfloat16(),
                               atol=0, rtol=0)


@pytest.mark.parametrize("concat_xyz", [True, False])
def test_implicit_decoder_matches_jax(concat_xyz):
    rs = np.random.RandomState(2)
    bounds = ((-1.0, -1.0, -0.1), (1.0, 1.0, 1.9))
    shape = (8, 10, 12)
    params = _np_tree(jdec.init_implicit_decoder(jax.random.PRNGKey(1), 6, 2,
                                                 concat_xyz))
    dec = tdec.ImplicitDecoder(6, 2, concat_xyz)
    dec.load_state_dict(tconv.to_tensors({
        "mlp.0.weight": params["fc1"]["w"].T, "mlp.0.bias": params["fc1"]["b"],
        "mlp.2.weight": params["fc2"]["w"].T, "mlp.2.bias": params["fc2"]["b"]}))
    vol = rs.randn(2, 6, *shape).astype(np.float32)
    pts = rs.uniform(-1.3, 2.2, (2, 150, 3)).astype(np.float32)  # some outside
    pts[:, :2] = [bounds[0], bounds[1]]
    want = jdec.implicit_decoder(params, jnp.asarray(vol),
                                 JaxGrid.from_bounds(bounds, shape),
                                 jnp.asarray(pts), concat_xyz)
    with torch.no_grad():
        got = tdec.implicit_decoder(dec, torch.as_tensor(vol),
                                    VoxelGrid.from_bounds(bounds, shape),
                                    torch.as_tensor(pts), concat_xyz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# SemAbs3D forward, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,p,q", [(TINY, 2, 2), (TINY, 1, 3), (C16, 2, 2)],
                         ids=["tiny", "tiny-shared-volume", "c16"])
def test_semabs3d_forward_matches_jax(kw, p, q):
    jcfg, tcfg = _cfgs(**kw)
    params = _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(0), jcfg))
    model = tconv.from_jax_params(params, tcfg, device="cpu")
    b = _batch(np.random.RandomState(3), 1, p=p, q=q)
    keys = ("input_xyz_pts", "input_feature_pts", "output_xyz_pts")
    want = jax.jit(lambda pr, bt: jnets.semabs3d_forward(pr, jcfg, *bt))(
        params, tuple(jnp.asarray(b[k]) for k in keys))
    with torch.no_grad():
        got = tnets.semabs3d_forward(model, tcfg, *(torch.as_tensor(b[k]) for k in keys))
    assert got.shape == (1, q, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_feature_vol_with_tsdf_and_valid_mask_matches_jax():
    """The TSDF channel concat and the scatter's valid mask (not on the
    bench path), against JAX's channel-last feature volume."""
    jcfg, tcfg = _cfgs(**dict(TINY, network_inputs=("saliency", "tsdf")))
    params = _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(4), jcfg))
    model = tconv.from_jax_params(params, tcfg, device="cpu")
    rs = np.random.RandomState(4)
    b = _batch(rs, 1)
    tsdf = rs.randn(1, 16, 16, 16).astype(np.float32)
    valid = rs.rand(1, 64) > 0.25
    want = jax.jit(lambda pr, *a: jnets.semabs3d_feature_vol(pr, jcfg, *a))(
        params, jnp.asarray(b["input_xyz_pts"]), jnp.asarray(b["input_feature_pts"]),
        jnp.asarray(tsdf), jnp.asarray(valid))
    with torch.no_grad():
        got = tnets.semabs3d_feature_vol(
            model, tcfg, torch.as_tensor(b["input_xyz_pts"]),
            torch.as_tensor(b["input_feature_pts"]), torch.as_tensor(tsdf),
            torch.as_tensor(valid))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def _bulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def test_semabs3d_bf16_forward_matches_jax():
    """The bf16 path: the f32 scatter, the cast before the UNet, and the
    GroupNorm affine with its scale and shift rounded to bf16, against
    JAX's bf16 forward. The convolutions sum in f32 in other orders, so a
    rounding may land one bf16 ulp apart and spread from there. Tolerances:
    feature volume mean |diff| <= 2^-8 mean |ref| and max |diff| <= 2^-6
    max |ref|; logits mean |diff| <= 2^-7 mean |ref| and max |diff| <= 2
    bf16 ulps of max |ref|. (The GroupNorm affine applied in f32, or the
    scatter in bf16, at least doubles the volume's mean difference;
    sampling with a bf16 grid at least doubles the logits'.)"""
    jcfg, tcfg = _cfgs(**TINY)
    params = _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(0), jcfg))
    model = tconv.from_jax_params(params, tcfg, device="cpu")
    b = _batch(np.random.RandomState(6), 1)
    keys = ("input_xyz_pts", "input_feature_pts", "output_xyz_pts")
    jin, tin = (tuple(jnp.asarray(b[k]) for k in keys),
                tuple(torch.as_tensor(b[k]) for k in keys))
    jvol = jax.jit(lambda pr, a, f: jnets.semabs3d_feature_vol(
        pr, jcfg, a, f, compute_dtype=jnp.bfloat16))(params, *jin[:2])
    jlog = jax.jit(lambda pr, bt: jnets.semabs3d_forward(
        pr, jcfg, *bt, compute_dtype=jnp.bfloat16))(params, jin)
    with torch.no_grad():
        vol = tnets.semabs3d_feature_vol(model, tcfg, *tin[:2],
                                         compute_dtype=torch.bfloat16)
        log = tnets.semabs3d_forward(model, tcfg, *tin, compute_dtype=torch.bfloat16)
    assert vol.dtype == log.dtype == torch.bfloat16 and jlog.dtype == jnp.bfloat16
    for got, want, mean_tol, max_tol in (
            (vol.permute(0, 2, 3, 4, 1), jvol, 2.0**-8, lambda r: 2.0**-6 * r),
            (log, jlog, 2.0**-7, lambda r: 2 * _bulp(r))):
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        diff, ref = np.abs(got - want), np.abs(want)
        assert diff.mean() <= mean_tol * ref.mean(), (diff.mean(), ref.mean())
        assert diff.max() <= max_tol(ref.max()), (diff.max(), ref.max())


def _reference_state_dict(rs, cfg):
    """A SemAbs3D state dict in the reference layout, DDP-prefixed."""
    model = tnets.init_net(0, cfg, device="cpu")
    sd = {f"module.{k}": rs.randn(*v.shape).astype(np.float32) * 0.3
          for k, v in model.state_dict().items()}
    sd["module.steps"] = np.full(1, 1234.0, np.float32)
    return sd


def test_reference_state_dict_loads_to_the_same_forward():
    jcfg, tcfg = _cfgs(**TINY)
    sd = _reference_state_dict(np.random.RandomState(6), tcfg)
    params = _np_tree(convert_semabs3d_state_dict(dict(sd)))
    model = tconv.from_state_dict(sd, tcfg, device="cpu")
    assert float(model.steps) == 1234.0
    b = _batch(np.random.RandomState(7), 1)
    keys = ("input_xyz_pts", "input_feature_pts", "output_xyz_pts")
    want = jax.jit(lambda pr, bt: jnets.semabs3d_forward(pr, jcfg, *bt))(
        params, tuple(jnp.asarray(b[k]) for k in keys))
    with torch.no_grad():
        got = tnets.semabs3d_forward(model, tcfg, *(torch.as_tensor(b[k]) for k in keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError):  # strict: an unknown key is refused
        tconv.from_state_dict({**sd, "module.extra.weight": np.zeros(1)}, tcfg,
                              device="cpu")


def test_relations_copy_matches_jax():
    assert tnets.RELATIONS == jnets.RELATIONS


def test_init_semabs3d_matches_jax_shapes_and_is_seeded():
    jcfg, tcfg = _cfgs(**TINY)
    want = tconv.jax_params_to_state_dict(
        _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(0), jcfg)), tcfg)
    a = tnets.init_net(11, tcfg, device="cpu").state_dict()
    b = tnets.init_net(11, tcfg, device="cpu").state_dict()
    assert set(a) == set(want) | {"steps"}
    for k, v in want.items():
        assert tuple(a[k].shape) == v.shape, k
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    with pytest.raises(ValueError):
        tnets.init_net(0, dataclasses.replace(tcfg, reduce_method="mean"), device="cpu")


# ---------------------------------------------------------------------------
# loss, optimizer, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("balance", [False, True])
def test_ovssc_and_vool_losses_match_jax(balance):
    rs = np.random.RandomState(8)
    logits = (rs.randn(2, 3, 50) * 4).astype(np.float32)
    labels = rs.randint(0, 2, (2, 3, 50)).astype(np.float32)
    ignore = rs.rand(2, 3, 50) < 0.2
    for jfn, tfn in ((jlosses.ovssc_loss, tlosses.ovssc_loss),
                     (jlosses.vool_loss, tlosses.vool_loss)):
        want = jfn(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(ignore),
                   balance, per_sample=True)
        got = tfn(torch.as_tensor(logits), torch.as_tensor(labels),
                  torch.as_tensor(ignore), balance, per_sample=True)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    pad = rs.rand(2, 3) < 0.5
    oob, fr = rs.rand(2, 3, 50) < 0.1, rs.rand(2, 3, 50) < 0.1
    np.testing.assert_array_equal(
        tlosses.ovssc_ignore_mask(*map(torch.as_tensor, (pad, oob, fr))).numpy(),
        np.asarray(jlosses.ovssc_ignore_mask(*map(jnp.asarray, (pad, oob, fr)))))


def test_lamb_steps_match_jax():
    """Several updates on tensors including a zero one (trust ratio 1),
    weight decay on, a warmup schedule (the first update uses schedule(1))."""
    rs = np.random.RandomState(9)
    shapes = [(5, 4), (7,), (3, 3, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    params[1][:] = 0
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(4)]
    sched = tsched.make_schedule("linear", 3, 10)
    jsched_fn = jsched.make_schedule("linear", 3, 10)

    tx = jax_lamb(lambda c: 1e-2 * jsched_fn(c), weight_decay=1e-2)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    opt = Lamb(tp, lr=1e-2, schedule=sched, weight_decay=1e-2)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.as_tensor(x)
        opt.step()
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear",
                                  "cosine", "cosine_with_restarts"])
def test_schedules_match_jax(name):
    want, got = jsched.make_schedule(name, 20, 200), tsched.make_schedule(name, 20, 200)
    for step in range(0, 230, 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"{name} step {step}")


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------


def test_three_train_steps_match_jax():
    jcfg, tcfg = _cfgs(**TINY)
    params = _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(0), jcfg))
    batch = _batch(np.random.RandomState(6), 1)
    opt_kw = dict(lr=1e-2, num_warmup_steps=1, num_training_steps=50)

    jtx = jtrain.make_optimizer(**opt_kw)
    jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx)
    jstep = jtrain.make_train_step(jtrain.ovssc_forward_loss, jcfg, jtx,
                                   compute_dtype=jnp.float32, donate=False)
    ttx = ttrain.make_optimizer(**opt_kw)
    tstate = ttrain.init_train_state(tconv.from_jax_params(params, tcfg, device="cpu"),
                                     ttx)
    tstep = ttrain.make_train_step(ttrain.ovssc_forward_loss, tcfg, ttx,
                                   compute_dtype=torch.float32)
    jb, tb = _jax(batch), _torch(batch)
    for i in range(3):
        jstate, jstats = jstep(jstate, jb)
        tstate, tstats = tstep(tstate, tb)
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    assert tstate.step == 3 and int(jstate.step) == 3
    want = tconv.jax_params_to_state_dict(_np_tree(jstate.params), tcfg)
    got = dict(tstate.model.named_parameters())
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


OVSSC_CASE = CASES["ovssc/semantic_abstraction"]  # TINY, JAX init from key 0
# batch seeds of the bf16 tests; scripts/torch_ovssc_bf16_readings.py reads
# seeds 6-10
BF16_SEEDS = (6, 7, 8)


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_bf16_train_step_matches_jax(seed):
    """One train step at bf16 compute from the same weights, against JAX's
    ``make_train_step(compute_dtype=jnp.bfloat16)``, on three batches.
    Later steps are not compared: LAMB's trust ratio turns the bf16
    gradients' rounding differences into parameter differences of the
    update's own size.

    Tolerances, set from the readings of
    ``scripts/torch_ovssc_bf16_readings.py`` over batch seeds 6-10:
    - loss rtol 5e-5 (read 3.2e-6 to 2.4e-5; the control below shows the
      gap is where the port rounds other than JAX: the UNet's sums, the
      sampler's weights, the linears);
    - grad norm: |port - JAX| <= 2e-3 |JAX| + 3/4 of JAX's own bf16-vs-f32
      move of it (read 5.8e-4 to 9.0e-3 of |JAX|, against JAX moves of
      1.0e-4 to 2.0e-2; at most 0.54 of the bound). The backward rounds
      its bf16 sums in other orders too, so the gap grows where bf16
      moves the grad norm most;
    - accuracy rtol 1e-4 (read equal);
    - both ways: the port's bf16 logits move from its f32 logits by 0.5 to
      1.25 times as much as JAX's do from JAX's (mean |diff|, read 0.82 to
      0.90), and lie nearer JAX's bf16 logits than 3/4 of JAX's own move
      (read 0.58 to 0.67 of it); a port that ran f32 whatever the compute
      dtype fails the first. (A GroupNorm affine in f32, a bf16 scatter or
      a bf16 sampler grid each move the grad norm by 3e-3 to 8e-3.)"""
    runs = bf16_and_f32_runs(OVSSC_CASE, OVSSC_CASE.jax_params(),
                             _batch(np.random.RandomState(seed), 1))
    (port, plog), (jax_, jlog) = runs["port", "bf16"], runs["jax", "bf16"]
    (port32, plog32), (jax32, jlog32) = runs["port", "f32"], runs["jax", "f32"]
    np.testing.assert_allclose(port["loss"], jax_["loss"], rtol=5e-5)
    np.testing.assert_allclose(port["accuracy"], jax_["accuracy"], rtol=1e-4)
    jax_move = abs(jax_["grad_norm"] - jax32["grad_norm"])
    assert (abs(port["grad_norm"] - jax_["grad_norm"])
            <= 2e-3 * jax_["grad_norm"] + 0.75 * jax_move), (port, jax_, jax32)
    jax_drift = np.abs(jlog - jlog32).mean()
    assert 0.5 <= np.abs(plog - plog32).mean() / jax_drift <= 1.25
    assert np.abs(plog - jlog).mean() <= 0.75 * jax_drift


def ovssc_bf16_control_runs(seed):
    """SemAbs3D's bf16 forward-loss on batch ``seed``: JAX's, the port's,
    and the port's with JAX's roundings (its decoder handed the bf16 volume
    that JAX's decoder got, its sampler weights and linears rounded as JAX
    rounds them) -> {name: (loss, logits)}."""
    params = OVSSC_CASE.jax_params()
    b = _batch(np.random.RandomState(seed), 1)
    vols = []
    jax_decoder = jnets.implicit_decoder

    def capture(p, vol, *args, **kw):
        vols.append(vol)
        return jax_decoder(p, vol, *args, **kw)

    with mock.patch.object(jnets, "implicit_decoder", capture):
        jl, jaux = OVSSC_CASE.jax_loss()(params, OVSSC_CASE.jcfg, _jax(b), False,
                                         jnp.bfloat16)
    out = {"jax": (float(jl), np.asarray(jaux["logits"].astype(jnp.float32)))}
    # JAX's volume is channel-last
    jax_vol = torch.as_tensor(np.array(vols[0].astype(jnp.float32)))
    jax_vol = jax_vol.permute(0, 4, 1, 2, 3).bfloat16()

    def run():
        with torch.no_grad():
            loss, aux = OVSSC_CASE.torch_loss()(
                tconv.from_jax_params(params, OVSSC_CASE.tcfg, device="cpu"),
                OVSSC_CASE.tcfg, _torch(b), False, torch.bfloat16)
        return float(loss), aux["logits"].float().numpy()

    out["port"] = run()
    port_decoder = tnets.implicit_decoder
    with mock.patch.object(tnets, "implicit_decoder",
                           lambda dec, vol, *a, **kw: port_decoder(dec, jax_vol, *a, **kw)), \
            mock.patch.object(tdec, "grid_sample_3d", jax_rounding_sampler), \
            mock.patch.object(tdec, "linear", jax_rounding_linear):
        out["port, JAX's roundings"] = run()
    return out


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_bf16_ovssc_logit_gap_is_where_the_port_rounds(seed):
    """The control for the loss tolerance above. With JAX's roundings in
    the port (``ovssc_bf16_control_runs``), its bf16 logits come within
    1/20 of their gap to JAX's (read 1/55 to equal over seeds 6-10, 99.2 to
    100% of them bit for bit, against 33.6 to 37.1% without) and its loss
    within rtol 1e-5 (read 0 to 3.9e-6, against 3.2e-6 to 2.4e-5 without;
    ``scripts/torch_ovssc_bf16_readings.py``)."""
    runs = ovssc_bf16_control_runs(seed)
    jl, jlog = runs["jax"]
    (loss, logits), (ctrl_loss, ctrl_logits) = runs["port"], runs["port, JAX's roundings"]
    gap, ctrl_gap = np.abs(logits - jlog).mean(), np.abs(ctrl_logits - jlog).mean()
    assert ctrl_gap <= gap / 20, (ctrl_gap, gap)
    assert (ctrl_logits == jlog).mean() >= 0.98
    np.testing.assert_allclose(ctrl_loss, jl, rtol=1e-5)
    assert abs(ctrl_loss - jl) < abs(loss - jl)


def test_eval_step_matches_jax():
    jcfg, tcfg = _cfgs(**TINY)
    params = _np_tree(jnets.init_semabs3d(jax.random.PRNGKey(2), jcfg))
    batch = _batch(np.random.RandomState(10), 2)
    batch["padding_mask"][1, 1] = True
    want = jtrain.make_eval_step(jtrain.ovssc_forward_loss, jcfg,
                                 compute_dtype=jnp.float32)(
        jax.tree_util.tree_map(jnp.asarray, params), _jax(batch))
    got = ttrain.make_eval_step(ttrain.ovssc_forward_loss, tcfg,
                                compute_dtype=torch.float32)(
        tconv.from_jax_params(params, tcfg, device="cpu"), _torch(batch))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
