"""The port's train loop against the JAX package's, for
``tests/test_torch_experiment.py`` (OVSSC) and
``tests/test_torch_experiment_vool.py`` (VOOL): two epochs of each
package's ``train`` on one synthetic corpus (``tests/torch_data_cases.py``)
at the ``TINY_ARGS`` widths of ``tests/test_cli_train.py`` in f32, from
JAX's initial weights (carried across with ``from_jax_params``; the port's
own init draws from a ``torch.Generator``).

Tolerances:
- per-step loss and accuracy within rtol 1e-4; parameters after the run
  within rtol 1e-4, atol 1e-6 (what ``tests/test_torch_ovssc.py`` holds
  one step to);
- ``detailed_stats.pkl``: the same rows and key columns as JAX's; each
  metric within atol 1e-6 (both packages count the same points in f32),
  except in a row where a query point that is not ignored has a logit
  within 1e-4 of the cutoff. The two packages' logits differ by up to
  ~1e-5, so such a point may fall on either side of the cutoff; its row
  is left out of the metric comparison, and at most a quarter of the rows
  may be.
"""
import pickle
from unittest import mock

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from semantic_abstraction_tpu.cli import common as jcommon
from semantic_abstraction_tpu.runtime import experiment as jexp
from semantic_abstraction_tpu_torch.cli import common as tcommon
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.runtime import experiment as texp
from semantic_abstraction_tpu_torch.runtime.train import init_train_state
from torch_data_cases import TINY_ARGS, jax_native  # noqa: F401 (a fixture)

NEAR = 1e-4


def loop_args(corpus, *extra, port=True):
    """The CLI namespace of ``TINY_ARGS`` on ``corpus``: the port's (on the
    CPU) or the JAX package's."""
    argv = ["--file_path", corpus] + list(TINY_ARGS) + list(extra)
    if port:
        return tcommon.config_parser().parse_args(argv + ["--device", "cpu"])
    return jcommon.config_parser().parse_args(argv)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads(jax_native):
    """Two intra-op threads while a module's loops run: the tiny nets gain
    nothing from more, and the suite's parallel workers share the cores.
    (It also loads the JAX package's native kernels, ``jax_native``.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Recorder:
    """Wraps a package's make_train_step / make_eval_step to keep each
    step's stats and each eval's logits and ignore mask as numpy."""

    def __init__(self, mod):
        self.mod, self.steps, self.evals = mod, [], []

    def __enter__(self):
        make_train, make_eval = self.mod.make_train_step, self.mod.make_eval_step

        def train_step(*a, **kw):
            step = make_train(*a, **kw)

            def run(state, batch):
                state, stats = step(state, batch)
                self.steps.append({k: float(np.asarray(v)) for k, v in stats.items()})
                return state, stats
            return run

        def eval_step(*a, **kw):
            step = make_eval(*a, **kw)

            def run(params, batch):
                aux = step(params, batch)
                self.evals.append({k: np.asarray(aux[k]) for k in ("logits", "ignore")})
                return aux
            return run

        self._patches = [mock.patch.object(self.mod, "make_train_step", train_step),
                         mock.patch.object(self.mod, "make_eval_step", eval_step)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def run_both(task, corpus, logs):
    """Two epochs of JAX's ``train`` and of the port's from the same initial
    weights -> the recorders, final parameters and timings of both."""
    jargs = loop_args(corpus, port=False)
    jsetup = jexp.setup_experiment(jargs, task, "semantic_abstraction")
    init = jax.tree_util.tree_map(np.asarray, jsetup["state"].params)
    with Recorder(jexp) as jrec:
        jstate = jexp.train(jargs, jsetup, log_dir=str(logs / "jax"))

    targs = loop_args(corpus)
    tsetup = texp.setup_experiment(targs, task, "semantic_abstraction")
    model = tconv.from_jax_params(init, tsetup["cfg"], "cpu")
    tsetup["state"] = init_train_state(model, tsetup["tx"])
    timings = []
    with Recorder(texp) as trec:
        tstate = texp.train(targs, tsetup, log_dir=str(logs / "port"), timings=timings)
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    return dict(task=task, jrec=jrec, trec=trec, jparams=jparams, tstate=tstate,
                cfg=tsetup["cfg"], logs=logs, timings=timings)


def check_train_steps(runs):
    jrec, trec = runs["jrec"], runs["trec"]
    assert len(trec.steps) == len(jrec.steps) == 4  # 2 epochs x 2 train scenes
    for i, (a, b) in enumerate(zip(jrec.steps, trec.steps)):
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=f"step {i} {k}")
    timings = runs["timings"]
    assert [t["steps"] for t in timings] == [2, 2]
    assert all(t["loader_wait_s"] >= 0 and t["wall_s"] > 0 for t in timings)


def check_params_after_train(runs):
    ref = tconv.to_tensors(tconv.jax_params_to_state_dict(runs["jparams"], runs["cfg"]))
    got = tconv.to_reference_state_dict(runs["tstate"].model)
    buffers = {k for k, _ in runs["tstate"].model.named_buffers()}
    assert set(got) - buffers == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert runs["tstate"].step == 4


def _near_cutoff_rows(evals, cutoff):
    rows = []
    for e in evals:
        near = (np.abs(e["logits"] - cutoff) < NEAR) & ~e["ignore"].astype(bool)
        rows.append(near.any(-1).reshape(-1))
    return np.concatenate(rows)


def check_detailed_stats(runs):
    task, logs = runs["task"], runs["logs"]
    with open(logs / "jax" / "detailed_stats.pkl", "rb") as f:
        jdf = pickle.load(f)
    with open(logs / "port" / "detailed_stats.pkl", "rb") as f:
        tdf = pickle.load(f)
    assert list(tdf.columns) == list(jdf.columns)
    assert len(tdf) == len(jdf) > 0
    key_cols = [c for c in jdf.columns
                if not pd.api.types.is_numeric_dtype(jdf[c])] + ["cutoff", "epoch"]
    for c in key_cols:
        assert tdf[c].tolist() == jdf[c].tolist(), c
    cutoff = jexp.eval_cutoffs_for(task, False)[0]
    near = _near_cutoff_rows(runs["trec"].evals, cutoff)
    assert len(near) == len(tdf)
    assert near.mean() <= 0.25, near.mean()
    metrics = [c for c in jdf.columns if c not in key_cols]
    assert "voxel32x32x32_iou" in metrics and "point_iou" in metrics
    for c in metrics:
        np.testing.assert_allclose(tdf[c].to_numpy()[~near], jdf[c].to_numpy()[~near],
                                   rtol=0, atol=1e-6, equal_nan=True, err_msg=c)
