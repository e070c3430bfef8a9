"""Import hygiene: the harness and the reference load neither JAX nor the
JAX package, and the reference loads nothing of the port."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
from benchmark import harness
for kind in ("metrics", "paths"):
    for p in glob.glob(os.path.join(harness.BENCH_DIR, kind, "*.py")):
        harness.load_module(p, "probe_" + os.path.basename(p).replace(".", "_"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(mods):
    code = PROBE.format(root=ROOT, mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    found = top_level_modules(["benchmark.harness", "benchmark.calibrate", "benchmark.counts",
                               "benchmark.weights", "benchmark.traffic.requests",
                               "benchmark.traffic.batches"])
    assert not found & {"jax", "jaxlib", "flax", "semantic_abstraction_tpu"}, found


def test_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r})\n"
            "import benchmark.reference.clip, benchmark.reference.semabs3d\n"
            "import benchmark.reference.tokenizer\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    found = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not found & {"jax", "jaxlib", "flax", "semantic_abstraction_tpu",
                        "semantic_abstraction_tpu_torch"}, found
