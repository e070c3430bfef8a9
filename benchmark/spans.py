"""Arithmetic shared by the readers of the port's stage spans (``metrics/``
with source ``program_span``).

The port records a span of each stage it runs while the torch profiler is
on (``semantic_abstraction_tpu_torch.trace``): in a run, the profiled
stretch. A unit is an outer span (an image's ``sa.relevancy.image``, a
step's ``sa.train.step``); its leaves are the spans opened directly in it.

- Stream shares: a leaf's stream milliseconds (from when the stream
  reached the span to when it left it, idle included) over the unit's.
- Idle shares: the spans' host times put on the trace's clock, each idle
  microsecond of the device (the complement of ``r.trace.busy_intervals``
  within the stretch, as ``device_idle_pct`` counts it) goes to the
  innermost span open on the host at that moment, or to ``outside`` (the
  benchmark's own code between units). The profiler writes Unix
  microseconds less a base: libkineto's ``ChromeTraceBaseTime`` (the Unix
  time floored to a multiple of 7,889,238 s) or none. The base kept is the
  one under which the units that the stretch overlaps lie inside it (1 ms
  of slack); where none fits, or nothing was profiled, a reader gives None.

The first reader of a cell prints one line to stderr: the units' table
(per unit: each leaf's count, host, stream and idle ms; the unit's stream
ms no leaf covers and its idle in no leaf; the idle outside any unit).
A buffer that dropped a record gives no number: some unit would miss a
leaf, and its share would be wrong. A program without the span module
(one that predates the spans) gives none either: its metrics are left out
of the line.
"""
from __future__ import annotations

import importlib
import json
import sys
from typing import Dict, List, Optional, Sequence

IMAGE = "sa.relevancy.image"
STEP = "sa.train.step"
PREP = ("sa.relevancy.text", "sa.relevancy.images", "sa.relevancy.plan",
        "sa.relevancy.tiles", "sa.relevancy.canvas")
TAIL = ("sa.relevancy.tail",)
BACKWARD = ("sa.train.backward",)
OPTIMIZER = ("sa.train.clip", "sa.train.optimizer")
OUTSIDE = "outside"
TRIMONTH_S = 7_889_238
SLACK_US = 1000.0


def port_trace():
    """The port's span module, or None where the program has none."""
    try:
        return importlib.import_module("semantic_abstraction_tpu_torch.trace")
    except ImportError:
        return None


def program_records() -> list:
    """The port's closed span records (none without the span module)."""
    mod = port_trace()
    return [] if mod is None else mod.records()


def bases_us(begin_ns: int) -> List[float]:
    """The bases a trace may subtract, in microseconds: the trimonth one of
    the Unix time ``begin_ns`` and none."""
    return [float((begin_ns // 10**9) // TRIMONTH_S * TRIMONTH_S * 10**6), 0.0]


class Units:
    """The profiled stretch's units of one outer span name, on the trace's
    clock (``base_us``), and every record that the stretch overlaps."""

    def __init__(self, r, outer: str, base_us: float, units: list, records: list):
        self.r, self.outer, self.base_us = r, outer, base_us
        self.units = units
        self.t0, self.t1 = r.trace.t0, r.trace.t1
        keep = {id(u) for u in units}
        self.leaves = [x for x in records if x.parent is not None and id(x.parent) in keep]
        self.overlapping = [x for x in records
                            if self.end(x) > self.t0 and self.begin(x) < self.t1]

    def begin(self, x) -> float:
        return x.begin_ns * 1e-3 - self.base_us

    def end(self, x) -> float:
        return x.end_ns * 1e-3 - self.base_us

    @property
    def n(self) -> int:
        return len(self.units)

    def stream_ms(self, names: Sequence[str]) -> float:
        return sum(x.stream_ms for x in self.leaves if x.name in names)

    def unit_stream_ms(self) -> float:
        return sum(u.stream_ms for u in self.units)

    def idle_us(self) -> Optional[Dict[str, float]]:
        """The stretch's device-idle microseconds by the innermost span open
        on the host (``OUTSIDE`` where none); None without device work."""
        busy = self.r.trace.busy_intervals
        if not busy:
            return None
        idle, at = [], self.t0
        for s, e in busy:
            if s > at:
                idle.append((at, min(s, self.t1)))
            at = max(at, e)
            if at >= self.t1:
                break
        if at < self.t1:
            idle.append((at, self.t1))
        out: Dict[str, float] = {}
        i = 0
        for a, b, name in self._segments():
            while i < len(idle) and idle[i][1] <= a:
                i += 1
            j = i
            while j < len(idle) and idle[j][0] < b:
                lo, hi = max(a, idle[j][0]), min(b, idle[j][1])
                if hi > lo:
                    out[name] = out.get(name, 0.0) + hi - lo
                j += 1
        return out

    def _segments(self):
        """[t0, t1] cut where a span opens or closes -> (start, end, the
        innermost open span's name or OUTSIDE): the open span that began
        last."""
        cuts = sorted({self.t0, self.t1}
                      | {min(max(t, self.t0), self.t1) for x in self.overlapping
                         for t in (self.begin(x), self.end(x))})
        by_begin = sorted(self.overlapping, key=self.begin)
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            name = OUTSIDE
            for x in by_begin:
                if self.begin(x) > mid:
                    break
                if self.end(x) > mid:
                    name = x.name
            yield a, b, name

    def table(self) -> dict:
        """Per unit: each leaf's count, host, stream and idle ms; the unit's
        unspanned stream ms and idle; the idle outside any unit."""
        idle = self.idle_us()
        rows: Dict[str, dict] = {}
        for x in self.leaves:
            row = rows.setdefault(x.name, {"count": 0, "host_ms": 0.0, "stream_ms": 0.0})
            row["count"] += 1
            row["host_ms"] += x.host_ms
            row["stream_ms"] += x.stream_ms
        for name, row in rows.items():
            row["idle_ms"] = None if idle is None else idle.get(name, 0.0) * 1e-3
            for k in row:
                if row[k] is not None:
                    row[k] /= self.n
        unit_ms = self.unit_stream_ms() / self.n
        out = {"unit": self.outer, "units": self.n, "base_us": self.base_us,
               "unit_stream_ms": unit_ms,
               "unspanned_stream_ms": unit_ms - sum(r["stream_ms"] for r in rows.values()),
               "leaves": rows}
        if idle is not None:
            per = 1e-3 / self.n
            out.update(idle_ms=sum(idle.values()) * per,
                       unspanned_idle_ms=idle.get(self.outer, 0.0) * per,
                       outside_idle_ms=idle.get(OUTSIDE, 0.0) * per)
        return out


def units(r, outer: str) -> Optional[Units]:
    """The units of the profiled stretch, or None (no stretch, no spans, a
    record dropped by the full buffer, or no base under which they lie
    inside the stretch)."""
    mod = port_trace()
    if r.trace is None or mod is None or mod.dropped():
        return None
    records = program_records()
    outers = [x for x in records if x.name == outer]
    if not outers:
        return None
    t0, t1 = r.trace.t0, r.trace.t1
    for base in bases_us(outers[0].begin_ns):
        spans = [(x, x.begin_ns * 1e-3 - base, x.end_ns * 1e-3 - base) for x in outers]
        hit = [s for s in spans if s[2] > t0 and s[1] < t1]
        if hit and all(t0 - SLACK_US <= b and e <= t1 + SLACK_US for _, b, e in hit):
            return Units(r, outer, base, [x for x, _, _ in hit], records)
    return None


_reported = set()


def _report(metric: str, u: Units) -> None:
    """Print the units' table once a process, from the first reader of
    their outer span."""
    if u.outer in _reported:
        return
    _reported.add(u.outer)
    print(f"spans {metric} " + json.dumps(u.table()), file=sys.stderr, flush=True)


def stream_pct(r, metric: str, outer: str, leaves: Sequence[str]):
    """100 x the leaves' stream ms over the units' stream ms."""
    u = units(r, outer)
    if u is None:
        return None
    _report(metric, u)
    total = u.unit_stream_ms()
    return 100.0 * u.stream_ms(leaves) / total if total > 0 else None


def idle_pct(r, metric: str, outer: str, leaves: Sequence[str]):
    """100 x the device-idle time while the innermost open span was one of
    the leaves over the stretch's time."""
    u = units(r, outer)
    if u is None:
        return None
    idle = u.idle_us()
    if idle is None or u.t1 <= u.t0:
        return None
    _report(metric, u)
    return 100.0 * sum(idle.get(n, 0.0) for n in leaves) / (u.t1 - u.t0)
