"""The port imports neither JAX nor anything of the JAX package, and no
module builds a kernel at import. Checked in a fresh interpreter, since
this test process has JAX loaded (tests/conftest.py)."""
import os
import pkgutil
import subprocess
import sys

import semantic_abstraction_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        semantic_abstraction_tpu_torch.__path__, "semantic_abstraction_tpu_torch."))


def test_port_modules_are_found():
    mods = _port_modules()
    for name in ("clip.model", "clip.saliency", "clip.relevancy", "clip.convert",
                 "clip.tokenizer", "ops.fused_mha", "ops._build", "ops.sampling",
                 "cli.generate_relevancy"):
        assert f"semantic_abstraction_tpu_torch.{name}" in mods


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
