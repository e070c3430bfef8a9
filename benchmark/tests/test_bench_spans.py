"""The span readers (``spans.py``, the ``program_span`` metrics): on a
synthetic stretch and buffer against a hand count, the base chosen by the
window, None where nothing fits, and a tiny traced run on the CPU."""
import os
import sys
import types

import pytest

from benchmark import spans
from benchmark.tests import tiny
from semantic_abstraction_tpu_torch import trace

BASE_NS = 1_790_857_026 * 10**9  # a multiple of 7,889,238 s
T0, T1 = 1000.0, 2000.0          # the stretch, in the trace's microseconds
BUSY = [[1050.0, 1150.0], [1300.0, 1500.0], [1850.0, 1950.0]]


def record(name, parent, begin_us, end_us):
    r = trace.Record(name, parent)
    r.begin_ns, r.end_ns = BASE_NS + int(begin_us * 1000), BASE_NS + int(end_us * 1000)
    return r


def step_records():
    """One step over [1100, 1900]: clip [1100, 1400], backward [1400, 1800],
    the step alone [1800, 1900]; and an earlier step, before the stretch."""
    old = record("sa.train.step", None, 100, 900)
    step = record("sa.train.step", None, 1100, 1900)
    return [old, record("sa.train.clip", old, 100, 900), step,
            record("sa.train.clip", step, 1100, 1400),
            record("sa.train.backward", step, 1400, 1800)]


def run_over(records, monkeypatch, shift_us=0.0, busy=BUSY):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    t = types.SimpleNamespace(t0=T0 + shift_us, t1=T1 + shift_us,
                              busy_intervals=[[s + shift_us, e + shift_us] for s, e in busy])
    return types.SimpleNamespace(trace=t)


def test_idle_goes_to_the_innermost_span_by_hand(monkeypatch):
    """Idle: [1000, 1050] outside, [1150, 1300] clip, [1500, 1800]
    backward, [1800, 1850] the step alone, [1950, 2000] outside."""
    r = run_over(step_records(), monkeypatch)
    u = spans.units(r, spans.STEP)
    assert u.base_us == BASE_NS * 1e-3 and u.n == 1
    idle = u.idle_us()
    assert idle == pytest.approx({"outside": 100.0, "sa.train.clip": 150.0,
                                  "sa.train.backward": 300.0, "sa.train.step": 50.0})
    busy = sum(e - s for s, e in BUSY)
    assert sum(idle.values()) == pytest.approx(T1 - T0 - busy)
    table = u.table()
    assert table["idle_ms"] == pytest.approx(0.6)
    assert (sum(row["idle_ms"] for row in table["leaves"].values())
            + table["outside_idle_ms"] + table["unspanned_idle_ms"]) == pytest.approx(0.6)
    assert table["unspanned_stream_ms"] == pytest.approx(0.1)
    assert spans.idle_pct(r, "m", spans.STEP, spans.OPTIMIZER) == pytest.approx(15.0)
    assert spans.stream_pct(r, "m", spans.STEP, spans.BACKWARD) == pytest.approx(50.0)
    assert spans.stream_pct(r, "m", spans.STEP, spans.OPTIMIZER) == pytest.approx(37.5)


def test_busy_past_the_stretch_is_cut_at_its_edges(monkeypatch):
    """Idle is [1200, 1950] alone."""
    r = run_over(step_records(), monkeypatch, busy=[[900.0, 1200.0], [1950.0, 2100.0]])
    idle = spans.units(r, spans.STEP).idle_us()
    assert idle == pytest.approx({"sa.train.clip": 200.0, "sa.train.backward": 400.0,
                                  "sa.train.step": 100.0, "outside": 50.0})


def test_the_base_is_chosen_by_the_window(monkeypatch):
    """A trace on absolute microseconds takes base zero."""
    r = run_over(step_records(), monkeypatch, shift_us=BASE_NS * 1e-3)
    u = spans.units(r, spans.STEP)
    assert u.base_us == 0.0
    assert spans.idle_pct(r, "m", spans.STEP, spans.OPTIMIZER) == pytest.approx(15.0, rel=1e-6)


@pytest.mark.parametrize("window,late_unit", [
    ((5000.0, 6000.0), False), ((-6000.0, -5000.0), False), ((T0, T1), True)])
def test_none_where_the_units_leave_the_window(monkeypatch, window, late_unit):
    """Wholly after or before the stretch, or a unit past its end by more
    than the slack."""
    records = step_records()
    if late_unit:
        records.append(record("sa.train.step", None, 1950, T1 + spans.SLACK_US + 50))
    r = run_over(records, monkeypatch)
    r.trace.t0, r.trace.t1 = window
    assert spans.units(r, spans.STEP) is None
    assert spans.stream_pct(r, "m", spans.STEP, spans.BACKWARD) is None
    assert spans.idle_pct(r, "m", spans.STEP, spans.OPTIMIZER) is None


def test_none_without_a_stretch_or_spans(monkeypatch):
    r = run_over(step_records(), monkeypatch)
    assert spans.stream_pct(types.SimpleNamespace(trace=None), "m", spans.STEP,
                            spans.BACKWARD) is None
    monkeypatch.setattr(spans, "program_records", lambda: [])
    assert spans.stream_pct(r, "m", spans.STEP, spans.BACKWARD) is None


def test_none_after_the_buffer_dropped_a_record(monkeypatch):
    """A unit may miss a leaf: no share rather than a wrong one."""
    r = run_over(step_records(), monkeypatch)
    monkeypatch.setattr(trace, "_dropped", 1)
    assert spans.units(r, spans.STEP) is None
    assert spans.stream_pct(r, "m", spans.STEP, spans.BACKWARD) is None
    assert spans.idle_pct(r, "m", spans.STEP, spans.OPTIMIZER) is None


SPAN_METRICS = ["prep_stream_pct.relevancy", "tail_stream_pct.relevancy",
                "prep_idle_pct.relevancy", "backward_stream_pct.train",
                "optimizer_stream_pct.train", "optimizer_idle_pct.train"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_gives_none(monkeypatch, name):
    """A program that predates the span module: each reader loads, finds
    nothing and gives None, so the line leaves its metric out."""
    from benchmark import harness
    r = run_over(step_records(), monkeypatch)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "semantic_abstraction_tpu_torch.trace", None)
    assert spans.port_trace() is None and spans.program_records() == []
    reader = harness.load_module(
        os.path.join(os.path.dirname(spans.__file__), "metrics", name + ".py"),
        "metric_" + name.replace(".", "_"))
    assert reader.read(r) is None


def test_the_table_is_printed_once_an_outer_span(monkeypatch, capsys):
    r = run_over(step_records(), monkeypatch)
    monkeypatch.setattr(spans, "_reported", set())
    spans.stream_pct(r, "a", spans.STEP, spans.BACKWARD)
    spans.stream_pct(r, "b", spans.STEP, spans.OPTIMIZER)
    spans.idle_pct(r, "c", spans.STEP, spans.OPTIMIZER)
    lines = capsys.readouterr().err.splitlines()
    assert [line.split()[:2] for line in lines] == [["spans", "a"]]


def test_no_device_intervals_give_no_idle(monkeypatch):
    r = run_over(step_records(), monkeypatch, busy=[])
    assert spans.idle_pct(r, "m", spans.STEP, spans.OPTIMIZER) is None
    assert spans.stream_pct(r, "m", spans.STEP, spans.BACKWARD) == pytest.approx(50.0)


@pytest.mark.parametrize("workload,stream,idle", [
    ("vitb32-relevancy-ours", ("prep_stream_pct.relevancy", "tail_stream_pct.relevancy"),
     "prep_idle_pct.relevancy"),
    ("ovssc-train-resident", ("backward_stream_pct.train", "optimizer_stream_pct.train"),
     "optimizer_idle_pct.train"),
])
def test_a_traced_run_on_the_cpu_reports_the_stream_shares(tiny_bench, workload, stream,
                                                           idle):
    """The CPU has no device intervals: the idle share is left out."""
    trace.clear()
    line = tiny.run_cell(tiny_bench, workload, trace=True)
    assert line["correct"], line
    for name in stream:
        assert 0.0 < line["metrics"][name]["value"] < 100.0, name
    assert idle not in line["metrics"]
