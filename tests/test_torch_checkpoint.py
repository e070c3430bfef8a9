"""The port's weight bridges and checkpoints against the JAX package on the
CPU: a reference-layout state dict built from JAX weights loads strictly
into each net (relation embeddings by name) and gives the JAX forward;
``load_net_checkpoint`` of a ``.pth`` gives the forward of the JAX
package's ``load_torch_net_checkpoint``; ``save_checkpoint`` ->
``load_checkpoint`` resumes a train step bit for bit.

Tolerances: logits rtol 1e-4, atol 1e-5 (f32, sums in another order);
resumed steps exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.models import convert as jconv
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.models import nets as tnets
from semantic_abstraction_tpu_torch.runtime import checkpoint as tckpt
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from torch_net_cases import ALL_CASES, CASES, batch, jax_forward, to_torch, torch_forward


def _reference_sd(case, seed=0, ddp=False):
    """The reference state dict of ``case``'s net from JAX weights: the
    parameters, the ``steps`` buffers, optionally DDP-prefixed."""
    sd = tconv.jax_params_to_state_dict(case.jax_params(seed), case.tcfg)
    for name, _ in tnets.init_net(0, case.tcfg, device="cpu").named_buffers():
        sd[name] = np.full(1, 7.0, np.float32)
    return {("module." + k if ddp else k): np.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("key", list(ALL_CASES))
def test_reference_state_dict_loads_into_each_net(key):
    """Strictly, DDP prefix or not, and to the forward of the JAX
    package's converter on the same state dict."""
    case = ALL_CASES[key]
    sd = _reference_sd(case, seed=1, ddp=key.startswith("vool"))
    if case.task == "vool" and case.approach != "clip_spatial":
        assert "module.relation_embeddings.in front of" in sd
    model = tconv.from_state_dict(sd, case.tcfg, device="cpu")
    params = jax.tree_util.tree_map(
        np.asarray, jconv.NET_CONVERTERS[(case.task, case.approach)](dict(sd)))
    b = batch(case, np.random.RandomState(20))
    np.testing.assert_allclose(torch_forward(case, model, b).numpy(),
                               jax_forward(case, params, b), rtol=1e-4, atol=1e-5)
    via_table = tconv.NET_CONVERTERS[(case.task, case.approach)](sd, case.tcfg, "cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(via_table.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("key,wrapped", [(k, True) for k in CASES]
                         + [("vool/semantic_abstraction", False)])
def test_load_net_checkpoint_matches_jax_loader(key, wrapped, tmp_path):
    """A reference ``.pth`` ({net, optimizer, epochs}, or a bare state
    dict), read by both packages' loaders, gives the same forward."""
    case = CASES[key]
    sd = {k: torch.tensor(v) for k, v in _reference_sd(case, seed=2).items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"net": sd, "optimizer": {}, "epochs": 7} if wrapped else sd, path)
    model, epoch = tckpt.load_net_checkpoint(path, case.task, case.approach, case.tcfg,
                                             device="cpu")
    params, jepoch = jconv.load_torch_net_checkpoint(path, case.task, case.approach)
    assert epoch == jepoch == (7 if wrapped else 0)
    b = batch(case, np.random.RandomState(21))
    np.testing.assert_allclose(
        torch_forward(case, model, b).numpy(),
        jax_forward(case, jax.tree_util.tree_map(np.asarray, params), b),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fault", ["unknown key", "missing key", "missing relation"])
def test_state_dict_load_is_strict(fault):
    case = CASES["vool/semantic_abstraction"]
    sd = _reference_sd(case)
    if fault == "unknown key":
        sd["completion_net.extra.weight"] = np.zeros(1, np.float32)
    elif fault == "missing key":
        del sd["spatial_sampler.mlp.0.bias"]
    else:
        del sd["relation_embeddings.on the left of"]
    with pytest.raises(RuntimeError):
        tconv.from_state_dict(sd, case.tcfg, device="cpu")


def test_reference_layout_names_each_relation_in_order():
    case = CASES["vool/semantic_aware"]
    model = tnets.init_net(3, case.tcfg, device="cpu")
    sd = tconv.to_reference_state_dict(model)
    assert "relation_embeddings" not in sd
    for i, rel in enumerate(tnets.RELATIONS):
        torch.testing.assert_close(sd[f"relation_embeddings.{rel}"],
                                   model.relation_embeddings[i].detach(), rtol=0, atol=0)
    other = tnets.init_net(4, case.tcfg, device="cpu")
    tconv.load_reference_state_dict(other, sd)
    for (k, v), (k2, v2) in zip(model.state_dict().items(), other.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(v, v2, rtol=0, atol=0)


@pytest.mark.parametrize("key", ["vool/semantic_abstraction", "ovssc/semantic_aware"])
def test_checkpoint_resumes_the_next_step_bit_for_bit(key, tmp_path):
    """Save after one step; a new state (other weights) restored from the
    file takes the same second step, bit for bit, as the run that went on;
    LAMB's moments and step counts come back with it."""
    case = CASES[key]
    tx = ttrain.make_optimizer(lr=1e-2, num_warmup_steps=1, num_training_steps=50)
    b = to_torch(batch(case, np.random.RandomState(22)))
    step = ttrain.make_train_step(case.torch_loss(), case.tcfg, tx,
                                  compute_dtype=torch.float32)
    state = ttrain.init_train_state(tnets.init_net(0, case.tcfg, device="cpu"), tx)
    state, _ = step(state, b)
    path = str(tmp_path / "latest.pth")
    tckpt.save_checkpoint(path, state, epoch=3, extra={"best_iou": 0.25})
    assert not (tmp_path / "latest.pth.tmp").exists()
    state, want = step(state, b)

    other = ttrain.init_train_state(tnets.init_net(5, case.tcfg, device="cpu"), tx)
    other, epoch, extra = tckpt.load_checkpoint(path, other)
    assert (epoch, extra, other.step) == (3, {"best_iou": 0.25}, 1)
    other, got = step(other, b)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, v), (_, v2) in zip(state.model.state_dict().items(),
                               other.model.state_dict().items()):
        assert torch.equal(v, v2), k
    assert all(other.optimizer.state[p]["step"] == 2 for p in other.model.parameters())
    saved = torch.load(path, weights_only=True)
    assert {"net", "optimizer", "epochs"} <= set(saved)
