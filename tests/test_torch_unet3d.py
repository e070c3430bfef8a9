"""The port's ResidualUNet3D against the JAX package's dense form
(``residual_unet3d(..., blocked_levels=0, remat=False)``) on the CPU, with
the weights carried across by the port's converter.

Tolerances: values atol=rtol=1e-4; every parameter's gradient rtol=1e-3
with atol 1e-5 of that tensor's largest gradient (the same f32 math;
convolution and moment sums over 8k-element volumes in another order, so a
gradient that cancels to near 0 keeps an absolute error of the sum's
size)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.models import unet3d as ju
from semantic_abstraction_tpu_torch.models import unet3d as tu
from semantic_abstraction_tpu_torch.models.convert import (
    jax_unet_to_state_dict,
    to_tensors,
)

IN, OUT, F_MAPS, LEVELS, GROUPS = 2, 5, 4, 3, 2


@pytest.fixture(scope="module")
def case():
    params = jax.tree_util.tree_map(
        np.asarray, ju.init_residual_unet3d(jax.random.PRNGKey(3), IN, OUT,
                                            F_MAPS, LEVELS))
    unet = tu.ResidualUNet3D(IN, OUT, tu.feature_maps_per_level(F_MAPS, LEVELS))
    unet.load_state_dict(to_tensors(jax_unet_to_state_dict(params)))
    rs = np.random.RandomState(0)
    x = rs.randn(2, IN, 16, 16, 16).astype(np.float32)
    w = rs.randn(2, OUT, 16, 16, 16).astype(np.float32)
    return params, unet, x, w


def test_forward_matches_jax(case):
    params, unet, x, _ = case
    want = jax.jit(lambda p, x_: ju.residual_unet3d(p, x_, GROUPS, remat=False,
                                                    blocked_levels=0))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tu.residual_unet3d(unet, torch.as_tensor(x), GROUPS)
    assert got.shape == (2, OUT, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_every_parameter_gradient_matches_jax(case):
    params, unet, x, w = case

    def loss(p):
        out = ju.residual_unet3d(p, jnp.asarray(x), GROUPS, remat=False,
                                 blocked_levels=0)
        return jnp.sum(jnp.sin(out) * w)

    jgrads = jax_unet_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))
    unet.zero_grad()
    out = tu.residual_unet3d(unet, torch.as_tensor(x), GROUPS)
    (torch.sin(out) * torch.as_tensor(w)).sum().backward()
    named = dict(unet.named_parameters())
    assert named.keys() == jgrads.keys()
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=1e-3,
                                   atol=1e-5 * np.abs(jgrads[name]).max(),
                                   err_msg=name)


def test_init_draws_the_jax_distributions():
    """Same shapes as the JAX init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    convs, GroupNorm at (1, 0); one seed gives one set of weights."""
    params = ju.init_residual_unet3d(jax.random.PRNGKey(0), IN, OUT, F_MAPS, LEVELS)
    want = jax_unet_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    unet = tu.init_residual_unet3d(torch.Generator().manual_seed(0), IN, OUT,
                                   F_MAPS, LEVELS)
    again = tu.init_residual_unet3d(torch.Generator().manual_seed(0), IN, OUT,
                                    F_MAPS, LEVELS)
    for name, p in unet.named_parameters():
        assert tuple(p.shape) == want[name].shape, name
        torch.testing.assert_close(p, dict(again.named_parameters())[name],
                                   atol=0, rtol=0)
        if "groupnorm.weight" in name:
            assert (p == 1).all()
        elif "groupnorm.bias" in name:
            assert (p == 0).all()
        else:
            bound = _bound(name, p)
            assert p.abs().max() <= bound, name
            if p.numel() >= 64:
                assert p.std() > 0.5 * bound / 3**0.5, name


def _bound(name, p):
    """1/sqrt(fan_in) of the layer a parameter belongs to."""
    if "final_conv" in name:
        return F_MAPS**-0.5
    if "upsample" in name:  # (I, O, 3, 3, 3) layout; the bias shares it
        return (F_MAPS * 2 ** (LEVELS - 1 - int(name.split(".")[1])) * 27) ** -0.5
    return (p.shape[1] * 27) ** -0.5


def test_group_norm_on_a_deep_level_shape():
    """The deepest full-size level's shape, (C=512, S=4^3) at 8 groups, which
    the Pallas moments kernel refuses (S below its chunk): the port's
    GroupNorm takes it. Against the JAX group_norm (plain XLA moments)."""
    rs = np.random.RandomState(1)
    x = rs.randn(1, 512, 4, 4, 4).astype(np.float32)
    scale, bias = rs.randn(512).astype(np.float32), rs.randn(512).astype(np.float32)
    want = ju.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 8)
    got = tu.group_norm(torch.as_tensor(x), torch.as_tensor(scale),
                        torch.as_tensor(bias), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
