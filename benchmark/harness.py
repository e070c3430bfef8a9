"""The harness: one run of one cell, driven by the files of this folder.

``BENCHMARK.json`` names the cell's configuration and traffic; the
configuration's file holds its sizes, ``traffic/<traffic>.json`` the
traffic's parameters and the driver that serves it (``paths/<path>.py``),
``limits/<cell>.json`` the limit of each number compared for ``correct``,
``metrics/<metric>.py`` the reader of each per-layer metric and
``kernels/<metric>/*.txt`` the device kernels a kernel metric reads. A new
cell, metric or kernel list is a new file; nothing here names one.

A run: check the card, let the driver set up and measure its window of
``--seconds`` (``Run.loop``, or ``Run.start_window`` and ``Run.end_window``),
with ``--trace 1`` profile a short steady stretch after it (``Run.profile``),
check what the window produced against the plain reference (``Run.check``),
and print one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import glob
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_abstraction_tpu")
GIB = 2.0 ** 30


def process_start_time() -> float:
    """The wall-clock time this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """BENCHMARK.json and the files it names, found by name."""

    def __init__(self, bench_dir: str = BENCH_DIR):
        self.dir = bench_dir
        self.root = os.path.dirname(bench_dir)
        self.data = load_json(os.path.join(self.root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "traffic", name + ".json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.dir, "limits", cell + ".json"))

    def metrics_for(self, cell: str, kind: str) -> List[dict]:
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def kernel_patterns(self, metric: str) -> List[str]:
        """The union of the lines of ``kernels/<metric>/*.txt``."""
        out = []
        for path in sorted(glob.glob(os.path.join(self.dir, "kernels", metric, "*.txt"))):
            with open(path) as f:
                out += [s.strip() for s in f if s.strip() and not s.startswith("#")]
        return out


class Trace:
    """What a profiled stretch shows: device intervals and names, the
    host's ops, the stretch's wall time."""

    def __init__(self, events: List[dict], window_name: str):
        win = [e for e in events if e.get("name") == window_name
               and e.get("cat") in ("user_annotation", "cpu_instant_event", "python_function",
                                    "cpu_op")]
        self.device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("cat") == "cpu_op"]
        if win:
            self.t0, self.t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
        elif self.device:
            self.t0 = min(s for _, s, _ in self.device)
            self.t1 = max(s + d for _, s, d in self.device)
        else:
            self.t0 = self.t1 = 0.0
        self.kernels = [k for k in self.device if k[0] and not k[0].startswith("Memcpy")
                        and not k[0].startswith("Memset")]
        self.busy_intervals = self._union([(s, s + d) for _, s, d in self.device])

    @staticmethod
    def _union(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) * 1e-6

    def kernel_time_s(self, patterns: List[str]) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        iv = [(s, s + d) for n, s, d in self.kernels if any(p in n for p in patterns)]
        return sum(e - s for s, e in self._union(iv)) * 1e-6

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0.0) + d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        edges = [self.t0] + [x for iv in self.busy_intervals for x in iv] + [self.t1]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                gaps.append((s, e))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            inner = [h for h in host if h[1] <= mid <= h[1] + h[2]]
            label = min(inner, key=lambda h: h[2])[0] if inner else "host: no op"
            out.append([label[:120], (e - s) * 1e-6])
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": out}


class Run:
    """One run of one cell: what the manifest gives the driver, and what
    the driver gives back."""

    def __init__(self, manifest: Manifest, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda"):
        import torch

        self.manifest, self.workload, self.seed = manifest, workload, seed
        self.seconds, self.trace_on = seconds, trace
        self.cell = manifest.cell(workload)
        self.config = manifest.config(self.cell["config"])
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.limits = manifest.limits(workload)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_process = process_start_time()
        self.e2e: Dict[str, float] = {}
        self.checks: List[tuple] = []
        self.attempted = self.failed = 0
        self.facts: dict = {}
        self.trace: Optional[Trace] = None
        self.trace_units = 0
        self.unit_s = math.nan  # unprofiled seconds a unit (image, step)
        self.setup_s = self.window_s = math.nan
        self.peak_bytes = self.window_peak_bytes = 0
        self._t_window = None

    # -- the measured window ------------------------------------------------

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        """Ends set-up: every shape is warm. Resets the peak memory."""
        import torch

        self.sync()
        if self.cuda:
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t_window = time.perf_counter()
        self.setup_s = time.time() - self.t_process
        return self._t_window

    def end_window(self) -> float:
        """Ends the window at a synchronise -> its seconds."""
        import torch

        self.sync()
        self.window_s = time.perf_counter() - self._t_window
        if self.cuda:
            self.window_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            self.peak_bytes = max(self.peak_bytes, self.window_peak_bytes)
        self.e2e["setup_s"] = self.setup_s
        self.e2e["peak_mem_gib"] = self.window_peak_bytes / GIB
        return self.window_s

    def loop(self, fn: Callable[[int], None], first: int = 0) -> int:
        """The window: ``fn(i)`` for i = first, first + 1, ... until
        ``seconds`` have passed, then a synchronise -> the count."""
        t0 = self.start_window()
        i, marks = first, [t0]
        while marks[-1] - t0 < self.seconds:
            fn(i)
            i += 1
            marks.append(time.perf_counter())
        self.end_window()
        print("unit seconds " + " ".join(f"{b - a:.4f}" for a, b in zip(marks, marks[1:])),
              file=sys.stderr)
        return i - first

    # -- the traced stretch ----------------------------------------------------

    def profile(self, fn: Callable[[], None], units: int) -> None:
        """Profile ``fn`` (``units`` images or steps) with the device's
        activity; keeps its kernels and host ops."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.sync()
        with profile(activities=acts) as prof:
            with record_function("bench.traced"):
                fn()
                self.sync()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.trace = Trace(events, "bench.traced")
        self.trace_units = units
        del events
        gc.collect()

    def kernel_patterns(self, metric: str) -> List[str]:
        return self.manifest.kernel_patterns(metric)

    # -- correct -------------------------------------------------------------

    def check(self, name: str, value: float) -> None:
        """One compared number, held to its limit in limits/<cell>.json."""
        self.checks.append((name, float(value), float(self.limits[name])))

    @property
    def correct(self) -> bool:
        names = {n for n, _, _ in self.checks}
        return (bool(self.checks) and names == set(self.limits)
                and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks))

    def judge(self, numbers: Dict[str, float]) -> bool:
        """``correct`` of readings that a control or a fault gave in the
        program's place: each compared number through ``check`` against its
        limit (a number it did not give fails)."""
        self.checks = []
        for name in self.limits:
            self.check(name, numbers.get(name, math.inf))
        return self.correct

    def free_program(self) -> None:
        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def card_or_exit(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell asks for {chips} cards and "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        raise SystemExit(2)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info(run: Run) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": int(run.cell["chips"]), "memory_peak_bytes": int(run.peak_bytes)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i",
                              str(run.device.index or 0)],
                             capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def read_metrics(run: Run, kind: str) -> Dict[str, dict]:
    """The cell's metrics of ``kind``: end-to-end from the driver, per-layer
    from their readers (one that finds nothing is left out)."""
    out = {}
    for m in run.manifest.metrics_for(run.workload, kind):
        if kind == "end_to_end":
            if m["name"] not in run.e2e:
                raise RuntimeError(f"the driver gave no {m['name']}")
            value = run.e2e[m["name"]]
        else:
            reader = load_module(os.path.join(run.manifest.dir, "metrics", m["name"] + ".py"),
                                 "metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Drive the cell's path and build the result's line."""
    driver = load_module(os.path.join(run.manifest.dir, "paths", run.traffic["path"] + ".py"),
                         "path_" + run.traffic["path"])
    driver.run(run)
    kind = "per_layer" if run.trace_on else "end_to_end"
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": read_metrics(run, kind)}
    if run.cuda:
        line["device"] = card_info(run)
    else:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace_on and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    manifest = Manifest()
    cell = manifest.cell(opts.workload)
    card_or_exit(int(cell["chips"]))
    run = Run(manifest, opts.workload, opts.seed, opts.seconds, bool(opts.trace))
    line = execute(run)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the process loaded {found}; the port must run without "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"correct {line['correct']}", file=sys.stderr)
    for n, v, lim in run.checks:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0

