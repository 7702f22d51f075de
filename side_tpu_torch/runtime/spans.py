"""Spans at the layer boundaries of the validation pass, the device tail and
the training loop.

`span(name, id)` marks one stretch of host time.  With no profiler running
it does nothing: one check of the profiler's state, nothing allocated or
recorded, no device work and no fence.  Under `torch.profiler` it does two
things:

- on a thread the profiler records, it enters a host range named
  `side::<name>`, which the operator's trace (`val.py --profile`, or any
  `torch.profiler.profile`) shows beside the kernels.  The range is a plain
  CPU operation, not a user annotation, so it puts no event on the device's
  timeline;
- it appends (name, id, thread, start, end), on `time.perf_counter_ns()`,
  to a bounded in-memory buffer.  The buffer also holds the spans of threads
  the profiler does not record (it records no operation of a thread it did
  not start), such as `run_pass`'s producer: those record when the call that
  started the thread was profiled, passed as `call`.

Profiler event names carry no id (a trace sums events by name); ids go into
the buffer only.

`begin()` opens one profiled pass or epoch call and records its anchor,
`side::anchor`: a profiler event and a buffer entry taken at the same
instant, with which a reader moves buffer spans onto the trace's clock.
`recorded()` returns the buffer by call, oldest first.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 1 << 15      # buffer entries; a 3,769-frame pass records ~10,000

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    id: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


class Call(NamedTuple):
    """One profiled call's anchor (None once the buffer has dropped it) and
    its spans in the order they ended."""
    anchor: Optional[Span]
    spans: List[Span]


_buffer = deque(maxlen=CAPACITY)        # (call number, Span)
_numbers = itertools.count(1)
_current = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "call", "range", "t0")

    def __init__(self, name: str, id: Optional[int], call: int):
        self.name, self.id, self.call = name, id, call

    def __enter__(self):
        self.range = None
        if _profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(
                "side::" + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _buffer.append((self.call, Span(self.name, self.id,
                                        threading.get_ident(), self.t0, t1)))
        return False


def span(name: str, id: Optional[int] = None, call: Optional[int] = None):
    """A context manager over one stretch of host time.  `call`: the token
    `begin()` gave the call that started this thread, for a thread the
    profiler does not record; without it the span records while the
    profiler records on this thread, into the latest call."""
    if call is None:
        if not _profiler_enabled():
            return _OFF
        call = _current
    return _On(name, id, call)


def begin() -> Optional[int]:
    """At the start of a pass or epoch call: None unless the profiler
    records on this thread; else the new call's token, after its anchor."""
    global _current
    if not _profiler_enabled():
        return None
    _current = call = next(_numbers)
    t0 = time.perf_counter_ns()
    with torch._C._profiler._RecordFunctionFast("side::anchor"):
        pass
    t1 = time.perf_counter_ns()
    _buffer.append((call, Span("anchor", None, threading.get_ident(), t0,
                               t1)))
    return call


def recorded() -> List[Call]:
    """The buffer by profiled call, oldest first."""
    calls = {}
    for call, s in _buffer.copy():
        anchor, spans = calls.get(call, (None, []))
        if s.name == "anchor":
            anchor = s
        else:
            spans.append(s)
        calls[call] = Call(anchor, spans)
    return [calls[k] for k in sorted(calls)]
