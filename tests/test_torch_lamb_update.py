"""The clip + LAMB of ``ops.lamb_update`` on the CPU: its plain multi-tensor
version (the CPU path, the kernel's oracle) against the per-leaf clip and
LAMB the port ran before it, and the chunk table the kernels read.

The per-leaf code is kept here as it was (``_per_leaf_step``): the plain
version repeats its arithmetic op for op, so the two agree bit for bit.
The kernel itself runs on the card only
(``tests/test_torch_lamb_update_card.py``)."""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu_torch.models.lamb import Lamb
from semantic_abstraction_tpu_torch.ops import lamb_update as lu
from semantic_abstraction_tpu_torch.runtime import schedule as tsched

CHUNK = lu.CHUNK


@torch.no_grad()
def _per_leaf_step(params, state, groups, schedule, max_norm):
    """The port's former train step tail: ``global_norm`` and
    ``clip_by_global_norm_`` over the gradients there are, then
    ``Lamb.step`` leaf by leaf. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    for group in groups:
        b1, b2 = group["betas"]
        for p in group["params"]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st = state.setdefault(p, {})
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            mu = b1 * st["exp_avg"] + (1 - b1) * g
            nu = b2 * st["exp_avg_sq"] + (1 - b2) * g * g
            st["exp_avg"], st["exp_avg_sq"] = mu, nu
            st["step"] += 1
            lr = group["lr"] * schedule(st["step"])
            adam_step = mu / (torch.sqrt(nu) + group["eps"])
            if group["weight_decay"] != 0.0:
                adam_step = adam_step + group["weight_decay"] * p
            weight_norm = torch.linalg.vector_norm(p).clamp(0.0, group["clamp_weight_norm"])
            adam_norm = torch.linalg.vector_norm(adam_step)
            trust = torch.where((weight_norm == 0.0) | (adam_norm == 0.0),
                                torch.ones_like(weight_norm),
                                weight_norm / adam_norm.clamp_min(1e-30))
            p.add_((-lr * trust) * adam_step)
    return norm


# leaves: a zero one (trust 1), one of 1 element, one without a gradient,
# and leaves across chunk boundaries (CHUNK + 1, 2 * CHUNK + 3)
SHAPES = [(5, 4), (7,), (1,), (CHUNK + 1,), (3, 3, 2), (2, CHUNK + 1), (6,)]
ZERO, NO_GRAD = 1, 6


def _leaves(seed):
    rs = np.random.RandomState(seed)
    params = [rs.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
    params[ZERO][:] = 0
    grads = [[None if i == NO_GRAD else rs.randn(*s).astype(np.float32)
              for i, s in enumerate(SHAPES)] for _ in range(3)]
    return params, grads


def _groups(params, two_groups):
    """Param groups over ``params``: one, or two with other hyperparameters."""
    if not two_groups:
        return [dict(params=params, lr=1e-2, betas=(0.9, 0.999), eps=1e-6,
                     weight_decay=1e-2, clamp_weight_norm=10.0)]
    return [dict(params=params[:3], lr=1e-2, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=1e-2, clamp_weight_norm=10.0),
            dict(params=params[3:], lr=3e-3, betas=(0.8, 0.99), eps=1e-5,
                 weight_decay=0.0, clamp_weight_norm=0.5)]


@pytest.mark.parametrize("two_groups", [False, True])
@pytest.mark.parametrize("max_norm", [1.0, 1e6], ids=["clip", "no_clip"])
def test_plain_version_equals_the_per_leaf_clip_and_lamb(max_norm, two_groups):
    """Three clip + LAMB steps through ``Lamb`` (the plain version on the
    CPU) and through the per-leaf code, on a warmup schedule: the norms,
    the clipped gradients, the moments and the parameters agree bit for
    bit; the leaf without a gradient keeps none."""
    params, grads = _leaves(3)
    sched = tsched.make_schedule("linear", 3, 10)
    mine = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    old = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    opt = Lamb(_groups(mine, two_groups), schedule=sched)
    old_groups, old_state = _groups(old, two_groups), {}
    for step_grads in grads:
        for a, b, g in zip(mine, old, step_grads):
            a.grad, b.grad = (None, None) if g is None else (torch.as_tensor(g.copy()),
                                                             torch.as_tensor(g.copy()))
        norm = opt.clip_grad_norm_(max_norm)
        opt.step()
        want = _per_leaf_step(old, old_state, old_groups, sched, max_norm)
        assert torch.equal(norm, want)
        for a, b in zip(mine, old):
            assert torch.equal(a.detach(), b.detach())
            assert (a.grad is None) == (b.grad is None)
            if a.grad is not None:
                assert torch.equal(a.grad, b.grad)
            st, st_old = opt.state[a], old_state[b]
            assert st["step"] == st_old["step"]
            assert torch.equal(st["exp_avg"], st_old["exp_avg"])
            assert torch.equal(st["exp_avg_sq"], st_old["exp_avg_sq"])
    assert (float(norm) >= max_norm) == (max_norm == 1.0)  # the clip engaged or not
    assert mine[NO_GRAD].grad is None and opt.state[mine[NO_GRAD]]["step"] == 3


def test_step_without_clip_is_lamb_alone():
    """``step()`` with no ``clip_grad_norm_`` before it leaves the
    gradients as they are."""
    params, grads = _leaves(4)
    mine = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    old = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    opt = Lamb(mine, lr=1e-2, weight_decay=1e-2)
    for a, b, g in zip(mine, old, grads[0]):
        a.grad, b.grad = (None, None) if g is None else (torch.as_tensor(g.copy()),
                                                         torch.as_tensor(g.copy()))
    opt.step()
    _per_leaf_step(old, {}, _groups(old, False), lambda step: 1.0, float("inf"))
    for a, b in zip(mine, old):
        assert torch.equal(a.detach(), b.detach())
    assert torch.equal(mine[0].grad, torch.as_tensor(grads[0][0]))


def test_moments_are_updated_where_they_lie():
    """The state's tensors stay the same objects from step to step (the
    kernel writes them in place), and only the clip's step clips."""
    params, grads = _leaves(5)
    ps = [torch.nn.Parameter(torch.as_tensor(p)) for p in params]
    opt = Lamb(ps, lr=1e-2)
    for k, step_grads in enumerate(grads):
        for p, g in zip(ps, step_grads):
            p.grad = None if g is None else torch.as_tensor(g.copy())
        opt.clip_grad_norm_(0.5)
        opt.step()
        if k == 0:
            held = [(opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]) for p in ps]
    assert all(opt.state[p]["exp_avg"] is m and opt.state[p]["exp_avg_sq"] is v
               for p, (m, v) in zip(ps, held))


def test_a_step_reads_the_gradients_it_is_given():
    """Gradients replaced between ``clip_grad_norm_`` and ``step()``: the
    step reads the new ones (the leaves are gathered again), clipped by the
    norm already taken."""
    rs = np.random.RandomState(6)
    p0, g0, g1 = (rs.randn(9).astype(np.float32) for _ in range(3))
    a, b = (torch.nn.Parameter(torch.as_tensor(p0.copy())) for _ in range(2))
    opt_a, opt_b = Lamb([a], lr=1e-2), Lamb([b], lr=1e-2)
    a.grad, b.grad = torch.as_tensor(g0.copy()), torch.as_tensor(g0.copy())
    norm = opt_a.clip_grad_norm_(0.5)
    a.grad = torch.as_tensor(g1.copy())
    opt_a.step()
    b.grad = torch.as_tensor(g1 * np.float32(0.5) / norm.numpy())
    opt_b.step()
    torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=1e-7)


def test_a_group_at_different_steps_raises():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    opt = Lamb([a, b], lr=1e-2)
    a.grad, b.grad = torch.ones(3), torch.ones(2)
    opt.step()
    opt.state[b]["step"] = 5
    with pytest.raises(ValueError, match="different steps"):
        opt.step()


@pytest.mark.parametrize("numels,chunk", [
    ([1], 4), ([4], 4), ([5], 4), ([0, 3, 0], 4), ([9, 1, 8, 4], 4),
    ([CHUNK - 1, CHUNK, CHUNK + 1, 1, 3 * CHUNK], CHUNK)])
def test_chunk_table(numels, chunk):
    """Every chunk maps to its leaf, a leaf's chunks are consecutive from
    its first and cover it exactly (the last one shorter), and a leaf of
    no elements has none."""
    first, leaf_of = lu.chunk_table(numels, chunk)
    assert len(first) == len(numels)
    assert len(leaf_of) == sum(-(-n // chunk) for n in numels)
    assert leaf_of == sorted(leaf_of)
    for i, n in enumerate(numels):
        mine = [c for c, leaf in enumerate(leaf_of) if leaf == i]
        assert mine == list(range(first[i], first[i] + len(mine)))
        starts = [(c - first[i]) * chunk for c in mine]
        lengths = [min(chunk, n - s) for s in starts]
        assert sum(lengths) == n and all(0 < x <= chunk for x in lengths)


def test_semabs3d_leaves_make_2251_chunks():
    """The full-size SemAbs3D's leaf sizes (``SemAbs3DConfig()``) at the
    default chunk: one block a chunk."""
    from semantic_abstraction_tpu_torch.models.nets import SemAbs3DConfig, init_net

    sizes = [p.numel() for p in init_net(0, SemAbs3DConfig(), device="cpu").parameters()]
    first, leaf_of = lu.chunk_table(sizes)
    assert (len(sizes), sum(sizes), len(leaf_of)) == (121, 35_403_969, 2251)
    assert first[-1] == len(leaf_of) - 1


def test_cpu_leaves_take_the_plain_version():
    ps = [torch.nn.Parameter(torch.ones(3))]
    leaves = lu.Leaves(ps, [torch.ones(3)], [torch.zeros(3)], [torch.zeros(3)], [(0, 1)])
    assert leaves.table is None
    before = lu.global_grad_norm.launches
    torch.testing.assert_close(lu.global_grad_norm(leaves), torch.tensor(3.0).sqrt())
    assert lu.global_grad_norm.launches == before


@pytest.mark.parametrize("bad", ["dtype", "strides", "shape", "device"])
def test_the_kernel_path_refuses_what_it_does_not_take(bad):
    """The checks the card path makes before it builds a table: float32,
    contiguous, one device, a leaf's tensors of one shape; no fallback."""
    p, g = torch.ones(4, 2), torch.ones(4, 2)
    m, v = torch.zeros(4, 2), torch.zeros(4, 2)
    if bad == "dtype":
        g = g.double()
    elif bad == "strides":
        m = torch.zeros(2, 4).t()
    elif bad == "shape":
        v = torch.zeros(8)
    else:
        g = g.to("meta")
    with pytest.raises(ValueError, match="lamb_update"):
        lu._check([p], [g], [m], [v])


def test_leaves_on_another_device_type_raise():
    p = torch.ones(3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lu.Leaves([p], [None], [torch.zeros_like(p)], [torch.zeros_like(p)], [(0, 1)])
