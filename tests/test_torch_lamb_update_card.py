"""The CUDA clip + LAMB kernels (``ops/lamb_update``) against their plain
PyTorch version, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the
kernels have no CPU mode. The file imports neither JAX nor the JAX
package, so that it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_lamb_update_card.py

Tolerance: the kernels round every elementwise step as the plain version
does and sum in another order (the global norm, each leaf's |p| and |u|).
So the norms agree to f32 summation rounding, rtol 1e-5, and what follows
from them inherits that: the clipped gradients and the moments to rtol
1e-5 (and 1e-5 of the leaf's largest first moment, whose terms cancel),
and each parameter to 1e-5 of its leaf's largest change plus 4 units in
the last place of p (a product that differs in its last bit can round p
the other way, once a step).
"""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu_torch.models.lamb import Lamb
from semantic_abstraction_tpu_torch.models.nets import (SemAbs3DConfig, SemAbsVOOLConfig,
                                                        init_net)
from semantic_abstraction_tpu_torch.ops import lamb_update as lu
from semantic_abstraction_tpu_torch.runtime import checkpoint as ckpt
from semantic_abstraction_tpu_torch.runtime import train

SMALL = dict(voxel_shape=(16, 16, 16), unet_num_channels=8, unet_f_maps=4, unet_num_groups=2,
             unet_num_levels=3, pts_feat_extractor_hidden_dim=16)
# the train cell's recipe, at a learning rate that moves the weights
TX = train.make_optimizer(lr=1e-2, weight_decay=1e-5, grad_max_norm=2.0,
                          num_warmup_steps=1, num_training_steps=50)
ULP = 2.0 ** -23


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def launches() -> int:
    return lu.global_grad_norm.launches + lu.lamb_update_.launches


def draw_grads(params, seed, scale=1.0, unread=()):
    """A gradient a leaf (None for the indices in ``unread``)."""
    g = torch.Generator(device=params[0].device).manual_seed(seed)
    return [None if i in unread else
            torch.randn(p.shape, generator=g, device=p.device) * scale
            for i, p in enumerate(params)]


class Plain:
    """The plain version's state beside a ``Lamb``: copies of the
    parameters and moments, stepped by ``lamb_update_reference``."""

    def __init__(self, params):
        self.p = [p.detach().clone() for p in params]
        self.p0 = [p.clone() for p in self.p]
        self.m = [torch.zeros_like(p) for p in self.p]
        self.v = [torch.zeros_like(p) for p in self.p]
        self.steps = 0

    def step(self, grads, max_norm):
        """One clip + LAMB step; clips ``grads`` in place, as the kernel
        clips ``p.grad``."""
        self.steps += 1
        norm = lu.grad_norm_reference(grads)
        lu.lamb_update_reference(self.p, grads, self.m, self.v,
                                 lr=TX.lr * TX.schedule(self.steps), betas=(0.9, 0.999),
                                 eps=1e-6, weight_decay=TX.weight_decay,
                                 clamp_weight_norm=10.0, norm=norm, max_norm=max_norm)
        return norm


def lamb_step(opt, params, grads, max_norm):
    """One clip + LAMB step of ``opt`` from copies of ``grads``."""
    for p, g in zip(params, grads):
        p.grad = None if g is None else g.clone()
    norm = opt.clip_grad_norm_(max_norm)
    opt.step()
    return norm


def assert_within_tolerance(opt, params, plain, grads):
    """The module docstring's tolerance, leaf by leaf; returns the worst
    share of each tolerance used."""
    worst = dict(grad=0.0, m=0.0, v=0.0, p=0.0)

    def use(key, err, tol):
        share = float((err / tol).max()) if err.numel() else 0.0
        worst[key] = max(worst[key], share)
        assert share <= 1.0, (key, share)

    for i, p in enumerate(params):
        st = opt.state[p]
        if grads[i] is not None:
            use("grad", (p.grad - grads[i]).abs(), 1e-5 * grads[i].abs() + 1e-30)
        m_ref, v_ref = plain.m[i], plain.v[i]
        use("m", (st["exp_avg"] - m_ref).abs(),
            1e-5 * (m_ref.abs() + m_ref.abs().max()) + 1e-30)
        use("v", (st["exp_avg_sq"] - v_ref).abs(), 1e-5 * v_ref.abs() + 1e-30)
        change = (plain.p[i] - plain.p0[i]).abs().max()
        use("p", (p.detach() - plain.p[i]).abs(),
              1e-5 * change + 4 * ULP * plain.p[i].abs() + 1e-30)
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("max_norm", [2.0, 1e9], ids=["clip", "no_clip"])
def test_kernel_matches_plain_on_semabs3d(cuda, max_norm):
    """The train cell's net, SemAbs3DConfig() (121 leaves, 35,403,969
    parameters), three clip + LAMB steps; with random unit gradients the
    norm is about 5,950, so a max norm of 2 clips and 1e9 does not."""
    params = list(init_net(0, SemAbs3DConfig(), device=cuda).parameters())
    assert len(params) == 121
    opt = Lamb(params, lr=TX.lr, schedule=TX.schedule, weight_decay=TX.weight_decay)
    plain = Plain(params)
    for k in range(3):
        grads = draw_grads(params, k)
        got = lamb_step(opt, params, grads, max_norm)
        want = plain.step(grads, max_norm)
        assert (float(want) >= max_norm) == (max_norm == 2.0)
        assert abs(float(got) - float(want)) <= 1e-5 * float(want)
        worst = assert_within_tolerance(opt, params, plain, grads)
    print(f"semabs3d max_norm {max_norm}: worst share of each tolerance {worst}")


def vool_batch(device, d=2, n=64, m=128):
    rs = np.random.RandomState(0)
    batch = {
        "input_xyz_pts": rs.uniform(-1, 1.9, (1, n, 3)).astype(np.float32),
        "output_xyz_pts": rs.uniform(-1.2, 2.1, (1, d, m, 3)).astype(np.float32),
        "output_label_pts": rs.randint(0, 2, (1, d, m)).astype(np.float32),
        "out_of_bounds_pts": rs.rand(1, d, m) < 0.1,
        "padding_mask": np.arange(d)[None] == d - 1,
        "spatial_relation_id": rs.randint(0, 7, (1, d)),
        "input_target_saliency_pts": rs.randn(1, d, n, 1).astype(np.float32),
        "input_reference_saliency_pts": rs.randn(1, d, n, 1).astype(np.float32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@pytest.mark.gpu
def test_kernel_matches_plain_on_vool_with_unread_leaves(cuda):
    """A small SemAbsVOOL's gradients from its forward-loss: the
    completion decoder is never read and gets no ``.grad``; the kernel
    takes zeros there, by the table's flag, and allocates nothing."""
    cfg = SemAbsVOOLConfig(completion=SemAbs3DConfig(**SMALL, decoder_concat_xyz_pts=False),
                           pointing_dim=16)
    model = init_net(0, cfg, device=cuda)
    loss, _ = train.vool_forward_loss(model, cfg, vool_batch(cuda), False, torch.float32)
    loss.backward()
    params = list(model.parameters())
    grads = [None if p.grad is None else p.grad.clone() for p in params]
    unread = [i for i, g in enumerate(grads) if g is None]
    assert unread and len(unread) < len(params)
    opt = Lamb(params, lr=TX.lr, schedule=TX.schedule, weight_decay=TX.weight_decay)
    plain = Plain(params)
    for k in range(3):
        step_grads = grads if k == 0 else draw_grads(params, k, 1e-3, unread)
        lamb_step(opt, params, step_grads, TX.grad_max_norm)
        plain.step(step_grads, TX.grad_max_norm)
        assert all(params[i].grad is None for i in unread)
        worst = assert_within_tolerance(opt, params, plain, step_grads)
    print(f"vool with {len(unread)} unread leaves: worst share of each tolerance {worst}")


@pytest.mark.gpu
def test_two_runs_are_bitwise_equal(cuda):
    params_a = list(init_net(0, SemAbs3DConfig(), device=cuda).parameters())
    params_b = [torch.nn.Parameter(p.detach().clone()) for p in params_a]
    opts = [Lamb(ps, lr=TX.lr, schedule=TX.schedule, weight_decay=TX.weight_decay)
            for ps in (params_a, params_b)]
    for k in range(2):
        grads = draw_grads(params_a, k)
        norms = [lamb_step(opt, ps, grads, 2.0) for opt, ps in zip(opts, (params_a,
                                                                            params_b))]
        assert torch.equal(*norms)
    for a, b in zip(params_a, params_b):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opts[0].state[a][key], opts[1].state[b][key])


@pytest.mark.gpu
def test_a_train_step_launches_three_kernels_and_never_synchronises(cuda):
    """Through ``make_train_step`` (the path of every net, the experiment
    loop and DDP): the clip + LAMB launch 3 kernels a step, at most 4
    whatever the leaf count, and neither the clip nor the step
    synchronises the card."""
    cfg = SemAbsVOOLConfig(completion=SemAbs3DConfig(**SMALL, decoder_concat_xyz_pts=False),
                           pointing_dim=16)
    state = train.init_train_state(init_net(0, cfg, device=cuda), TX)
    step = train.make_train_step(train.vool_forward_loss, cfg, TX, compute_dtype=torch.float32)
    batch = vool_batch(cuda)
    state, _ = step(state, batch)  # builds the kernels, makes the moments
    before = launches()
    state, _ = step(state, batch)
    assert launches() - before == 3
    opt = state.optimizer
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.clip_grad_norm_(TX.grad_max_norm)
        opt.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _state(device, seed):
    cfg = SemAbs3DConfig(**SMALL)
    return train.init_train_state(init_net(seed, cfg, device=device), TX)


@pytest.mark.gpu
@pytest.mark.parametrize("saved_on", ["cuda", "cpu"])
def test_a_checkpoint_loads_on_the_other_side(cuda, saved_on, tmp_path):
    """Two steps on one side (the kernel on the card, the plain version on
    the CPU), saved; loaded into a state on the other side, whose next step
    agrees with the saving side's next step within the tolerance."""
    other_on = "cpu" if saved_on == "cuda" else "cuda"
    src = _state(saved_on, 0)
    params = list(src.model.parameters())
    for k in range(2):
        lamb_step(src.optimizer, params, draw_grads(params, k), TX.grad_max_norm)
    path = str(tmp_path / "latest.ckpt")
    ckpt.save_checkpoint(path, src, epoch=1)
    dst, epoch, _ = ckpt.load_checkpoint(path, _state(other_on, 5))
    assert epoch == 1
    dst_params = list(dst.model.parameters())
    for a, b in zip(params, dst_params):
        assert torch.equal(a.detach().cpu(), b.detach().cpu())
        assert dst.optimizer.state[b]["exp_avg"].device == b.device
    grads = draw_grads(params, 2)
    before = [p.detach().clone() for p in params]
    lamb_step(src.optimizer, params, grads, TX.grad_max_norm)
    lamb_step(dst.optimizer, dst_params, [g.to(other_on) for g in grads], TX.grad_max_norm)
    for a, b, a0 in zip(params, dst_params, before):
        sa, sb = src.optimizer.state[a], dst.optimizer.state[b]
        assert sa["step"] == sb["step"] == 3
        a = a.detach()
        err = (a - b.detach().to(saved_on)).abs()
        assert (err <= 1e-5 * (a - a0).abs().max() + 4 * ULP * a.abs() + 1e-30).all()
        torch.testing.assert_close(sb["exp_avg_sq"].to(saved_on), sa["exp_avg_sq"],
                                   rtol=1e-5, atol=0)
