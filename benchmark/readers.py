"""Arithmetic shared by the per-layer metrics' readers (``metrics/``).

Each returns None where its run has nothing to read, and the harness then
leaves the metric out of the line."""
from __future__ import annotations

import math


def kernels_per_unit(r):
    """Device kernels of the profiled stretch over its images or steps."""
    if r.trace is None or not r.trace_units:
        return None
    return len(r.trace.kernels) / r.trace_units


def idle_pct(r):
    """100 - the profiled stretch's device busy time (the union of its
    kernel, copy and set intervals) over the unprofiled time of as many
    units in the same run."""
    if r.trace is None or not r.trace_units or not math.isfinite(r.unit_s):
        return None
    return 100.0 * (1.0 - r.trace.busy_s / (r.unit_s * r.trace_units))


def roofline_pct(r, metric: str, bound_key: str):
    """100 x the least time of the work the profiled units need (from
    ``counts``) over the device time of the kernels ``kernels/<metric>/``
    names."""
    if r.trace is None or bound_key not in r.facts:
        return None
    busy = r.trace.kernel_time_s(r.kernel_patterns(metric))
    if busy <= 0.0:
        return None
    return 100.0 * r.facts[bound_key] * r.trace_units / busy


def mfu_pct(r):
    """100 x the FLOPs a unit needs over the unprofiled seconds a unit, as
    a share of the bf16 peak."""
    if "flops_per_unit" not in r.facts or not math.isfinite(r.unit_s):
        return None
    return 100.0 * r.facts["flops_per_unit"] / r.unit_s / r.facts["peak_flops"]
