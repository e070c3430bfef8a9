"""The port's train, eval and summarize CLIs end to end on the CPU
(``--device cpu``), on a synthetic corpus with every eval split
(``tests/torch_data_cases.py``) at the ``TINY_ARGS`` widths of
``tests/test_cli_train.py``; the summarize tables against the JAX
package's on the same frames, which must be equal."""
import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from semantic_abstraction_tpu.cli import common as jcommon
from semantic_abstraction_tpu.cli import summarize as jsum
from semantic_abstraction_tpu_torch.cli import eval as eval_cli
from semantic_abstraction_tpu_torch.cli import summarize as tsum
from semantic_abstraction_tpu_torch.cli import train_ovssc, train_vool
from torch_data_cases import TINY_ARGS, make_corpus
from torch_loop_cases import jax_native, two_torch_threads  # noqa: F401 (fixtures)

SPLITS = {"train": [0, 1], "unseen_instances": [2], "unseen_instances_dr": [3],
          "unseen_instances_synonyms": [4], "novel_class": [5]}


def _tiny(epochs=2):
    args = list(TINY_ARGS) + ["--device", "cpu"]
    args[args.index("--epochs") + 1] = str(epochs)
    return args


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(d, n_scenes=6, splits=SPLITS)
    return str(d)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One training run of each (task, approach) the CLIs take."""
    logs = tmp_path_factory.mktemp("logs")
    out = {}
    for approach in ("semantic_abstraction", "semantic_aware"):
        log = str(logs / f"ovssc_{approach}")
        train_ovssc.main(["--file_path", corpus, "--log", log, "--approach", approach]
                         + _tiny())
        out["ovssc", approach] = log
    for approach in ("semantic_abstraction", "semantic_aware", "clip_spatial"):
        log = str(logs / f"vool_{approach}")
        train_vool.main(["--file_path", corpus, "--log", log, "--approach", approach]
                        + _tiny(1))
        out["vool", approach] = log
    return out


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("key", [("ovssc", "semantic_abstraction"),
                                 ("ovssc", "semantic_aware"),
                                 ("vool", "semantic_abstraction"),
                                 ("vool", "semantic_aware"),
                                 ("vool", "clip_spatial")])
def test_train_cli_writes_the_run(runs, key):
    log = runs[key]
    for name in ("latest.ckpt", "ckpt_0.ckpt", "args.pkl", "detailed_stats.pkl"):
        assert os.path.exists(os.path.join(log, name)), name
    args = _load(os.path.join(log, "args.pkl"))
    assert args["approach"] == key[1] and args["device"] == "cpu"
    if key[1] == "semantic_aware":
        assert args["network_inputs"] == ["rgb"]
    df = _load(os.path.join(log, "detailed_stats.pkl"))
    epochs = 2 if key[0] == "ovssc" else 1
    assert set(df["split"]) == set(SPLITS) - {"train"}
    assert sorted(set(df["epoch"])) == list(range(epochs))
    assert "voxel32x32x32_iou" in df.columns
    cols = {"label"} if key[0] == "ovssc" else {
        "target_obj_name", "reference_obj_name", "spatial_relation_name"}
    assert cols <= set(df.columns)
    ckpt = torch.load(os.path.join(log, "latest.ckpt"), weights_only=True)
    assert ckpt["epochs"] == epochs and ckpt["step"] == 2 * epochs


@pytest.fixture(scope="module")
def eval_stats(runs, corpus):
    """The eval CLI on the two semantic_abstraction runs' latest.ckpt."""
    out = {}
    for task in ("ovssc", "vool"):
        log = runs[task, "semantic_abstraction"]
        eval_cli.main(["--file_path", corpus, "--load", os.path.join(log, "latest.ckpt"),
                       "--task", task, "--num_workers", "0", "--device", "cpu"])
        out[task] = _load(os.path.join(log, "latest_eval_stats.pkl"))
    return out


@pytest.mark.parametrize("task", ["ovssc", "vool"])
def test_eval_cli_writes_all_cutoffs(eval_stats, task):
    df = eval_stats[task]
    assert len(df["cutoff"].unique()) == 25
    np.testing.assert_allclose(sorted(df["cutoff"].unique()), np.arange(-2.5, 0, 0.1))
    assert {"voxel32x32x32_iou", "voxel64x64x64_iou", "point_iou"} <= set(df.columns)
    assert set(df["split"]) == set(SPLITS) - {"train"}
    assert set(df["epoch"]) == {2 if task == "ovssc" else 1}
    real = df[df["point_iou"].notna()]
    assert len(real) > 0 and real["point_iou"].between(0, 1).all()


def test_summarize_tables_match_jax(eval_stats):
    ovssc = {"Ours": eval_stats["ovssc"], "Other": eval_stats["ovssc"].assign(
        voxel32x32x32_iou=eval_stats["ovssc"]["voxel32x32x32_iou"] * 0.5)}
    pd.testing.assert_frame_equal(tsum.summarize_ovssc(ovssc), jsum.summarize_ovssc(ovssc))
    vool = {"Ours": eval_stats["vool"]}
    table = tsum.summarize_vool(vool)
    pd.testing.assert_frame_equal(table, jsum.summarize_vool(vool))
    assert "mean" in set(table["relation"])
    nyu = {"Ours": eval_stats["ovssc"].rename(columns={"voxel64x64x64_iou": "voxel60x60x60_iou"})}
    pd.testing.assert_frame_equal(tsum.summarize_nyu(nyu), jsum.summarize_nyu(nyu))


def test_summarize_cli_prints_the_tables(eval_stats, tmp_path, capsys):
    for task in ("ovssc", "vool"):
        d = tmp_path / "ours" / task
        d.mkdir(parents=True)
        eval_stats[task].to_pickle(d / f"{task}_eval_stats.pkl")
    tsum.main(["--models-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "OVSSC THOR" in out and "FULL VOOL THOR" in out


def test_eval_restores_a_jax_written_args_pkl(runs, corpus, tmp_path):
    """An args.pkl of the JAX package's CLIs (with ``wire_dtype`` and a
    multi-chip ``num_devices``) restores; the eval keeps its own device."""
    src = runs["ovssc", "semantic_abstraction"]
    shutil.copy(os.path.join(src, "latest.ckpt"), tmp_path / "ovssc.ckpt")
    jargs = jcommon.config_parser().parse_args(
        ["--file_path", "elsewhere", "--wire_dtype", "float16"] + list(TINY_ARGS))
    jargs.num_devices = 4
    jcommon.save_args(str(tmp_path), jargs)
    eval_cli.main(["--file_path", corpus, "--load", str(tmp_path / "ovssc.ckpt"),
                   "--task", "ovssc", "--max_batches", "1", "--device", "cpu",
                   "--voxel_shapes", "16"])
    df = _load(tmp_path / "ovssc_eval_stats.pkl")
    assert "voxel16x16x16_iou" in df.columns and len(df["cutoff"].unique()) == 25


@pytest.mark.parametrize("cli", ["train_ovssc", "train_vool", "eval"])
def test_more_than_one_device_is_refused(cli, corpus, tmp_path):
    argv = ["--file_path", corpus, "--num_devices", "2", "--device", "cpu"]
    argv += ["--task", "ovssc", "--load", "x.ckpt"] if cli == "eval" else [
        "--log", str(tmp_path / "log")]
    mod = {"train_ovssc": train_ovssc, "train_vool": train_vool, "eval": eval_cli}[cli]
    with pytest.raises(SystemExit, match="one card"):
        mod.main(argv)
    assert not (tmp_path / "log").exists()


@pytest.mark.parametrize("cli", ["train_ovssc", "train_vool", "eval"])
def test_without_a_gpu_the_clis_raise(cli, corpus, tmp_path, monkeypatch):
    """No ``--device cpu`` and no card: the CLI raises before it writes or
    reads anything, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--file_path", corpus] + list(TINY_ARGS)
    argv += ["--task", "ovssc", "--load", "x.ckpt"] if cli == "eval" else [
        "--log", str(tmp_path / "log")]
    mod = {"train_ovssc": train_ovssc, "train_vool": train_vool, "eval": eval_cli}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not (tmp_path / "log").exists()


def test_profile_dir_writes_a_trace(corpus, tmp_path, monkeypatch):
    """SEMABS_PROFILE_DIR: a torch.profiler chrome trace of the train steps
    from the second on, written even when the run is shorter."""
    monkeypatch.setenv("SEMABS_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("SEMABS_PROFILE_STEPS", "5")
    train_ovssc.main(["--file_path", corpus, "--log", str(tmp_path / "log")] + _tiny(1))
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / traces[0]) > 0
