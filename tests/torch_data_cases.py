"""Synthetic scene corpora for the port's data and loop tests
(``tests/test_torch_{data,experiment,cli_train}.py``).

``tests/synthetic_scene.py`` ``make_scene`` writes a THOR-style scene file;
``augment_scene`` adds what the synonym and domain-randomized-rgb splits
read and ``make_scene`` does not write: a saliency row under each synonym
of a scene label (e.g. "couch" for "sofa"), a ``domain_randomized_rgb``
image, and its ``domain_randomized_rgb|ours`` saliency group.

``jax_native`` makes sure the JAX package's native loader kernels are
loaded in this process: its dataset items depend on them (the native and
numpy samplers draw different indices), and its build goes through one
fixed temporary name that parallel test workers can race on. A failed
build is retried once in a directory of this process's own
(``SEMABS_NATIVE_CACHE``, the JAX package's own setting).
"""
import os
import pickle

import h5py
import numpy as np
import pytest

from semantic_abstraction_tpu import native as jnative
from semantic_abstraction_tpu.data.hdf5 import resize_and_add_data
from synthetic_scene import make_scene
from test_cli_train import TINY_ARGS

from semantic_abstraction_tpu_torch.data.datasets import SYNONYMS

__all__ = ["TINY_ARGS", "augment_scene", "jax_native", "make_corpus"]


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    if not jnative.available():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SEMABS_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
            jnative._TRIED = False  # retry the build, in this process's directory
            assert jnative.available(), "the JAX package's native kernels did not build"
    return jnative


def augment_scene(path, rs):
    with h5py.File(str(path), "a") as f:
        sg = f["data/saliencies"]
        key = "rgb|ours"
        labels = [s.decode() for s in sg[key + "|saliency_text_labels"][:]]
        refs = list(sg[key][:])
        feats = sg[key + "|saliency_text_label_features"][:]
        new = [SYNONYMS[l] for l in labels if l in SYNONYMS]
        if new:
            rows = rs.randn(len(new), *f["saliencies"].shape[1:]).astype(np.float32) * 0.01
            refs += resize_and_add_data(f["saliencies"], rows)
            labels += new
            feats = np.concatenate(
                [feats, rs.randn(len(new), feats.shape[1]).astype(np.float32)])
        rgb = f["rgb"][:1]
        f["data"]["domain_randomized_rgb"] = (255 - rgb).astype(np.uint8)
        for k in ("rgb|ours", "domain_randomized_rgb|ours"):
            for suffix in ("", "|saliency_text_labels", "|saliency_text_label_features"):
                if k + suffix in sg:
                    del sg[k + suffix]
            sg[k] = np.array(refs, dtype=h5py.regionref_dtype)
            sg[k + "|saliency_text_labels"] = np.array(labels, dtype="S128")
            sg[k + "|saliency_text_label_features"] = feats
    return str(path)


def make_corpus(d, n_scenes=4, seed=0, splits=None):
    """``n_scenes`` augmented scenes under ``d`` named FloorPlan<room>_...,
    and ``ssc_split.pkl`` and ``vool_split.pkl`` holding ``splits`` (lists
    of scene indices by split; by default 2 train scenes, one
    ``unseen_instances`` and one ``novel_class``)."""
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n_scenes):
        name = f"FloorPlan{i + 1}_physics_{i}.hdf5"
        augment_scene(make_scene(os.path.join(str(d), name), rs), rs)
        names.append(name)
    splits = splits or {"train": [0, 1], "unseen_instances": [2],
                        "unseen_instances_dr": [], "unseen_instances_synonyms": [],
                        "novel_class": [3]}
    named = {k: [names[i] for i in v] for k, v in splits.items()}
    for fname in ("ssc_split.pkl", "vool_split.pkl"):
        with open(os.path.join(str(d), fname), "wb") as f:
            pickle.dump(named, f)
    return names
