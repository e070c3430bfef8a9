"""BENCHMARK.json against the rules it must keep, and the harness's
promise that a cell or a metric is new files only."""
import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.Manifest()


def test_keys_and_names(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert d["paths"] == ["benchmark"] and 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in d[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in d["end_to_end"]}
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert os.path.getsize(os.path.join(manifest.root, "BENCHMARK.json")) <= 64 * 1024


def test_every_name_resolves(manifest):
    d = manifest.data
    configs = {c["name"] for c in d["configs"]}
    used = set()
    for w in d["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        traffic = manifest.traffic(w["traffic"])
        assert os.path.exists(os.path.join(manifest.dir, "paths", traffic["path"] + ".py"))
        assert manifest.limits(w["name"])
        manifest.config(w["config"])
    assert used == configs
    for c in d["configs"]:
        assert c["file"].startswith("benchmark/") and all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) <= set(manifest.config(c["name"]))
    for m in d["per_layer"]:
        assert os.path.exists(os.path.join(manifest.dir, "metrics", m["name"] + ".py"))
        if "roofline" in m["name"]:
            assert manifest.kernel_patterns(m["name"])


def test_each_cell_reports_what_its_layers_move(manifest):
    d = manifest.data
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e
    for w in d["workloads"]:
        ends = {m["name"] for m in manifest.metrics_for(w["name"], "end_to_end")}
        per = manifest.metrics_for(w["name"], "per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and per
        for m in per:
            assert m["moves"] in ends, (w["name"], m["name"])


def test_files_are_named_as_names(manifest):
    for base, _, files in os.walk(manifest.dir):
        if "__pycache__" in base:
            continue
        for f in files:
            assert NAME.match(f), os.path.join(base, f)


def test_a_cell_and_a_metric_are_new_files(tmp_path):
    """A new cell (an entry and its traffic and limits files) and a new
    per-layer metric (an entry and its reader) run with no other edit."""
    bench = tiny.make_copy(str(tmp_path))
    with open(os.path.join(bench, "traffic", "resident-pool8.json")) as f:
        traffic = json.load(f)
    traffic["pool"] = 3
    with open(os.path.join(bench, "traffic", "resident-pool3.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(bench, "limits", "ovssc-train-resident.json"),
                os.path.join(bench, "limits", "ovssc-train-resident3.json"))
    with open(os.path.join(bench, "metrics", "steps_profiled.train.py"), "w") as f:
        f.write("def read(r):\n    return r.trace_units or None\n")
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(path) as f:
        d = json.load(f)
    d["workloads"].append({"name": "ovssc-train-resident3", "config": "semabs3d-ovssc",
                           "traffic": "resident-pool3", "chips": 1, "why": "a test cell"})
    for m in d["end_to_end"] + d["per_layer"]:
        if "ovssc-train-resident" in m.get("workloads", []):
            m["workloads"].append("ovssc-train-resident3")
    d["per_layer"].append({"name": "steps_profiled.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "train step",
                           "moves": "train_samples_per_s",
                           "workloads": ["ovssc-train-resident3"]})
    with open(path, "w") as f:
        json.dump(d, f)
    line = tiny.run_cell(bench, "ovssc-train-resident3", trace=True)
    assert line["correct"], line
    assert line["metrics"]["steps_profiled.train"]["value"] == 1
    assert "mfu.train" in line["metrics"]
