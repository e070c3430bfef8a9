"""Stage spans: where a unit of work's host time, device time and idle go.

``with span("sa.train.forward"):`` marks a stage of the port. The only
switch is the torch profiler: with none active (``torch.profiler.profile``,
``SEMABS_PROFILE_DIR``'s trace, a benchmark's traced stretch) a span checks
that and does nothing else. With one active it

- enters ``torch.profiler.record_function(name)``, so the span is in every
  export of that profiler, on its clock, beside the kernels it launched;
- appends a ``Record`` to a bounded buffer of this process: the name, the
  record of the span it opened in (``parent``, on the same thread), begin
  and end as ``time.time_ns()`` (the Unix clock the profiler's exports are
  converted to), and, once CUDA is initialised, a pair of timing events on
  the current stream at entry and at exit.

``records()`` gives the closed records; each has ``host_ms`` and
``stream_ms``, the stream's time from reaching the span's entry to reaching
its exit, idle included (``host_ms`` without CUDA). The buffer holds every
record since the process began or since the last ``clear()``, at most
``CAP`` of them, and counts those it drops (``dropped()``). Nothing in the
port clears it: a caller that profiles more than one stretch in a process
and reads the records calls ``clear()`` before each; a reader of the
records treats any drop as records missing (the benchmark profiles one
stretch a process, and its readers give no number after a drop).

``timed`` is a span that also adds its block's host seconds to a dict,
whether or not a profiler is active, for callers that report stage times
themselves.

Span names: ``sa.relevancy.*`` (``clip/saliency.py``, ``clip/relevancy.py``),
``sa.train.*`` (``runtime/train.py``), ``sa.loop.*``
(``runtime/experiment.py``), ``sa.visualize.*`` (``cli/visualize.py``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

import torch

CAP = 1 << 16

_OFF = contextlib.nullcontext()
_buffer: List["Record"] = []
_dropped = 0
_local = threading.local()


class Record:
    """One span: ``name``, ``parent`` (a Record or None), ``begin_ns`` and
    ``end_ns`` on the Unix clock."""

    __slots__ = ("name", "parent", "begin_ns", "end_ns", "_events", "_stream_ms")

    def __init__(self, name: str, parent: Optional["Record"]):
        self.name, self.parent = name, parent
        self.begin_ns = self.end_ns = 0
        self._events = None
        self._stream_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.begin_ns) * 1e-6

    @property
    def stream_ms(self) -> float:
        """The stream's milliseconds from the entry to the exit (waits for
        the exit's event); the host's without CUDA."""
        if self._events is None:
            return self.host_ms
        if self._stream_ms is None:
            start, end = self._events
            end.synchronize()
            self._stream_ms = start.elapsed_time(end)
        return self._stream_ms


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    # A nested span's host interval holds its own entry and exit, so that
    # spans opened one after another in a unit leave no host time between
    # them. A unit's (a span opened in none) leaves them out: they are the
    # caller's, and the first event a profiled stretch records costs ~1-2 ms.
    def __enter__(self) -> Record:
        global _dropped
        begin_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack = _stack()
        rec = Record(self.name, stack[-1] if stack else None)
        if len(_buffer) < CAP:
            _buffer.append(rec)
            if torch.cuda.is_initialized():
                rec._events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                rec._events[0].record()
        else:
            _dropped += 1
        stack.append(rec)
        rec.begin_ns = begin_ns if rec.parent is not None else time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = _stack().pop()
        end_ns = time.time_ns()
        if rec._events is not None:
            rec._events[1].record()
        self._rf.__exit__(*exc)
        rec.end_ns = end_ns if rec.parent is None else time.time_ns()
        return False


def span(name: str):
    """A context manager marking the stage ``name``: nothing unless the
    torch profiler is active (see the module's docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


class timed:
    """``span(name)``, and the block's host seconds added to
    ``seconds[key]`` when it ends without raising; with ``sync`` (a
    device), a CUDA device is synchronised before the clock is read, so the
    seconds include the block's device work."""

    __slots__ = ("name", "seconds", "key", "sync", "_span", "_t0")

    def __init__(self, name: str, seconds: dict, key: str,
                 sync: Optional[torch.device] = None):
        self.name, self.seconds, self.key, self.sync = name, seconds, key, sync

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                if self.sync is not None and self.sync.type == "cuda":
                    torch.cuda.synchronize(self.sync)
                self.seconds[self.key] = (self.seconds.get(self.key, 0.0)
                                          + time.perf_counter() - self._t0)
        finally:
            self._span.__exit__(exc_type, *exc)
        return False


def records() -> List[Record]:
    """The buffer's closed records, in the order they opened."""
    return [r for r in _buffer if r.end_ns]


def dropped() -> int:
    """Records not kept since the last ``clear()``: the buffer was full."""
    return _dropped


def clear() -> None:
    global _dropped
    _buffer.clear()
    _dropped = 0
