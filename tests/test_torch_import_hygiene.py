"""The port imports neither JAX nor anything of the JAX package, and no
module builds a kernel at import. Checked in a fresh interpreter, since
this test process has JAX loaded (tests/conftest.py), and by reading every
import statement of the port's sources and of chip_smoke.py."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import semantic_abstraction_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        semantic_abstraction_tpu_torch.__path__, "semantic_abstraction_tpu_torch."))


def test_port_modules_are_found():
    mods = _port_modules()
    for name in ("clip.model", "clip.saliency", "clip.relevancy", "clip.convert",
                 "clip.tokenizer", "ops.fused_mha", "ops.cam_accumulate", "ops._build",
                 "ops.sampling",
                 "cli.generate_relevancy", "ops.voxel", "ops.channel_moments",
                 "models.params", "models.unet3d", "models.decoder", "models.nets",
                 "models.convert", "models.lamb", "runtime.losses",
                 "runtime.schedule", "runtime.train", "runtime.metrics",
                 "runtime.checkpoint", "runtime.experiment", "native", "data",
                 "data.transforms", "data.hdf5", "data.datasets", "data.loader",
                 "cli.common", "cli.train_ovssc", "cli.train_vool", "cli.eval",
                 "cli.summarize", "parallel", "parallel.distributed", "clip.resnet",
                 "datagen", "datagen.naming", "datagen.receptacles",
                 "datagen.relations", "datagen.scene", "cli.generate_thor_data", "trace"):
        assert f"semantic_abstraction_tpu_torch.{name}" in mods


def _sources():
    pkg = os.path.join(REPO, "semantic_abstraction_tpu_torch")
    files = [os.path.join(root, f) for root, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _sources())
def test_no_source_imports_jax(path):
    """Also the imports inside functions, which the import check below
    does not run (chip_smoke.py imports the port only inside ``main``)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and n.level == 0]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "semantic_abstraction_tpu")]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, os, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'semantic_abstraction_tpu'"
        " or m.startswith('semantic_abstraction_tpu.'))\n"
        "assert not bad, bad\n"
        "from semantic_abstraction_tpu_torch.ops import _build\n"
        "assert not _build._loaded, 'a kernel was loaded at import'\n"
        "print('clean', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


_NO_H5PY_NO_PANDAS = """
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "pandas"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
import numpy as np

from semantic_abstraction_tpu_torch.data import DataLoader, collate
from semantic_abstraction_tpu_torch.runtime import experiment


class Items:
    def __len__(self):
        return 5

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "name": f"s{i}"}

    def set_epoch(self, epoch):
        pass


batches = list(DataLoader(Items(), batch_size=2, num_workers=2, shuffle=False))
assert [b["name"] for b in batches] == [["s0", "s1"], ["s2", "s3"], ["s4"]]
assert batches[0]["x"].shape == (2, 2, 3)
assert collate([Items()[0]])["x"].shape == (1, 2, 3)
assert "h5py" not in sys.modules and "pandas" not in sys.modules
print("ok", experiment.LOG_FLUSH)
"""


def test_data_and_experiment_import_without_h5py_and_pandas():
    """The card's machine has neither: the input pipeline and the loop import
    and a loader batches in-memory items there."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NO_H5PY_NO_PANDAS], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
