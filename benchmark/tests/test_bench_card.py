"""On the card: each cell for 10 s through the command the driver runs,
correct; and each cell's control and faults at the cell's own size,
against the program's own run of the same seed. Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider -q benchmark/tests/test_bench_card.py
"""
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in harness.Manifest().data["workloads"]]
SEPARATED = ["vitb32-relevancy-ours"]
SEED = 1618033988


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_for_10s(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "2718281828459", "--seconds", "10", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_read_worse_than_the_program(card, workload):
    """On one seed: each control and fault reads worse than the program in
    some compared number; in the cells whose control no sound run comes
    near, the harness judges each not correct. The train cell's fp8
    control is not separated by its norms on every seed (PERF.md)."""
    manifest = harness.Manifest()
    sound = harness.Run(manifest, workload, SEED, 3.0, False)
    line = harness.execute(sound)
    assert line["correct"], line["checks"]
    program = {k: v["value"] for k, v in line["checks"].items()}
    run = harness.Run(manifest, workload, SEED, 3.0, False)
    driver = harness.load_module(
        os.path.join(manifest.dir, "paths", run.traffic["path"] + ".py"),
        "path_" + run.traffic["path"])
    for name, numbers in driver.control(run).items():
        assert any(numbers[k] > program[k] for k in program if k in numbers), (name, numbers)
        judged = harness.Run(manifest, workload, SEED, 3.0, False)
        if workload in SEPARATED:
            assert not judged.judge(numbers), (name, judged.checks)
