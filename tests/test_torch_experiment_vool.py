"""Two epochs of the port's VOOL ``semantic_abstraction`` ``train``
against the JAX package's on the CPU, from JAX's initial weights: per-step
loss and accuracy, the parameters after the run and ``detailed_stats.pkl``,
at the tolerances stated in ``tests/torch_loop_cases.py``. (A file of its
own: JAX's VOOL train and eval steps take most of a minute to compile.)"""
import pytest

from torch_data_cases import make_corpus
from torch_loop_cases import (  # noqa: F401 (fixtures: two_torch_threads is autouse)
    check_detailed_stats,
    check_params_after_train,
    check_train_steps,
    run_both,
    jax_native,
    two_torch_threads,
)


@pytest.fixture(scope="module")
def vool_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(d, n_scenes=4)
    return run_both("vool", str(d), tmp_path_factory.mktemp("logs_vool"))


def test_train_steps_match_jax(vool_runs):
    check_train_steps(vool_runs)


def test_params_after_train_match_jax(vool_runs):
    check_params_after_train(vool_runs)


def test_detailed_stats_match_jax(vool_runs):
    check_detailed_stats(vool_runs)
