"""The port's experiment loop against the JAX package's on the CPU, at the
``TINY_ARGS`` widths of ``tests/test_cli_train.py`` in f32 on one synthetic
corpus (``tests/torch_data_cases.py``):

- ``device_batch``: the same keys, dtypes and values as JAX's;
- two epochs of OVSSC ``train`` against JAX's: steps, parameters and
  ``detailed_stats.pkl`` at the tolerances of ``tests/torch_loop_cases.py``
  (VOOL: ``tests/test_torch_experiment_vool.py``);
- resume: a run stopped after epoch 0 and resumed from its ``latest.ckpt``
  ends with the parameters, LAMB state and logged losses of an unbroken
  run, bit for bit; a reference ``.pth`` restores the net and the epoch;
- ``setup_experiment`` runs on the card unless the CPU is asked for.
"""
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.runtime import experiment as jexp
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.runtime import experiment as texp
from torch_data_cases import make_corpus
from torch_loop_cases import (  # noqa: F401 (fixtures: two_torch_threads is autouse)
    Recorder,
    check_detailed_stats,
    check_params_after_train,
    check_train_steps,
    loop_args,
    run_both,
    jax_native,
    two_torch_threads,
)



@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(d, n_scenes=4)
    return str(d)


def _batches(task, corpus):
    args = loop_args(corpus)
    setup = texp.setup_experiment(args, task, "semantic_abstraction")
    ds = setup["datasets"]["train"]
    from semantic_abstraction_tpu_torch.data import DataLoader

    return list(DataLoader(ds, batch_size=2, num_workers=0, shuffle=False))


@pytest.mark.parametrize("task", ["ovssc", "vool"])
def test_device_batch_matches_jax(task, corpus):
    batch = _batches(task, corpus)[0]
    names = {}

    def encoder(ns):
        for n in ns:
            names.setdefault(n, np.random.RandomState(len(names)).randn(512))
        return np.stack([names[n] for n in ns]).astype(np.float32)

    jb = jexp.device_batch(batch, task, None, encoder)
    tb = texp.device_batch(batch, task, "cpu", encoder)
    assert list(tb) == list(jb)
    for k in jb:
        a = np.asarray(jb[k])
        b = tb[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tb["output_label_pts"].dtype == torch.uint8
    if task == "vool":
        assert tb["target_obj_features"].shape == (2, 4, 512)


def _state_arrays(model, optimizer):
    sd = {k: v.detach().numpy().copy() for k, v in tconv.to_reference_state_dict(model).items()}
    opt = {f"{i}.{k}": (v.numpy().copy() if torch.is_tensor(v) else v)
           for i, st in optimizer.state_dict()["state"].items() for k, v in st.items()}
    return sd, opt


@pytest.fixture(scope="module")
def ovssc_runs(corpus, tmp_path_factory):
    return run_both("ovssc", corpus, tmp_path_factory.mktemp("logs_ovssc"))


def test_train_steps_match_jax(ovssc_runs):
    check_train_steps(ovssc_runs)


def test_params_after_train_match_jax(ovssc_runs):
    check_params_after_train(ovssc_runs)


def test_detailed_stats_match_jax(ovssc_runs):
    check_detailed_stats(ovssc_runs)


def test_resume_continues_bit_for_bit(corpus, tmp_path):
    """Epoch 0, a checkpoint, a fresh process state resumed from it, epoch 1:
    the parameters, LAMB state and losses of one unbroken two-epoch run."""
    def run(log, epochs, load=None):
        args = loop_args(corpus, "--load", load) if load else loop_args(corpus)
        setup = texp.setup_experiment(args, "ovssc", "semantic_abstraction")
        args.epochs = epochs  # the schedule stays sized for two epochs
        with Recorder(texp) as rec:
            state = texp.train(args, setup, log_dir=str(log))
        return state, rec.steps, setup["start_epoch"]

    full, full_steps, _ = run(tmp_path / "full", 2)
    _, first_steps, _ = run(tmp_path / "broken", 1)
    resumed, rest_steps, start = run(tmp_path / "broken2", 2,
                                     load=str(tmp_path / "broken" / "latest.ckpt"))
    assert start == 1 and resumed.step == full.step == 4
    assert first_steps + rest_steps == full_steps
    a_sd, a_opt = _state_arrays(full.model, full.optimizer)
    b_sd, b_opt = _state_arrays(resumed.model, resumed.optimizer)
    assert list(a_sd) == list(b_sd) and list(a_opt) == list(b_opt)
    for k in a_sd:
        np.testing.assert_array_equal(b_sd[k], a_sd[k], err_msg=k)
    for k in a_opt:
        np.testing.assert_array_equal(b_opt[k], a_opt[k], err_msg=k)


def test_resume_from_a_reference_pth_restores_the_net_and_epoch(corpus, tmp_path):
    args = loop_args(corpus)
    setup = texp.setup_experiment(args, "vool", "semantic_abstraction")
    sd = tconv.to_reference_state_dict(setup["state"].model)
    path = str(tmp_path / "vool.pth")
    torch.save({"net": {f"module.{k}": v for k, v in sd.items()}, "epochs": 7}, path)
    args = loop_args(corpus, "--load", path, "--seed", "1")
    other = texp.setup_experiment(args, "vool", "semantic_abstraction")
    assert other["start_epoch"] == 7
    got = tconv.to_reference_state_dict(other["state"].model)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    assert not other["state"].optimizer.state  # the optimizer starts fresh


def test_setup_defaults_to_the_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = loop_args(corpus)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texp.setup_experiment(args, "ovssc", "semantic_abstraction")
    del args.device  # a namespace without the flag: cuda as well
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texp.setup_experiment(args, "ovssc", "semantic_abstraction")
