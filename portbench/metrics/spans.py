"""What the span readers share: the program's span buffer, the idle time of
the host-traced stretch (`d["trace_host"]`: the gaps between the union of
its device events, from the first to the last), and its overlap with the
program's `side::<name>` host events (side_tpu_torch/runtime/spans.py).
Every function returns None where the program has no spans module (a
program that predates it) or the run has nothing to read."""

from __future__ import annotations

import bisect

PREFIX = "side::"


def _recorded():
    """The program's `recorded`, or None where it has no spans module."""
    try:
        from side_tpu_torch.runtime.spans import recorded
    except ImportError:
        return None
    return recorded


def host_trace(d, kind: str):
    """The host-traced stretch of a `kind` run on the card, or None."""
    if d.get("kind") != kind or d.get("device") != "cuda" or \
            _recorded() is None:
        return None
    t = d.get("trace_host")
    return t if t is not None and t.kernels else None


def union(intervals) -> list:
    """Sorted disjoint (start, end) intervals covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def idle(trace) -> list:
    """The gaps between the union of the trace's device events."""
    busy = union((s, e) for _, s, e in trace.kernels)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def side(trace, *names) -> list:
    """(start, end) of the trace's host events `side::<name>` for `names`."""
    full = {PREFIX + n for n in names}
    return [(s, e) for name, s, e in trace.host if name in full]


def idle_share(trace, intervals):
    """100 x the idle time inside `intervals` / all idle time, or None
    without intervals or idle time."""
    gaps = idle(trace)
    total = sum(e - s for s, e in gaps)
    if not intervals or total <= 0:
        return None
    return 100.0 * overlap(gaps, union(intervals)) / total


def idle_inside(d, kind: str, *names):
    """The share of the host-traced stretch's idle time inside the main
    thread's spans `names`."""
    t = host_trace(d, kind)
    return None if t is None else idle_share(t, side(t, *names))


def enqueues_inside(trace, intervals) -> int:
    """The host's CUDA calls that enqueue device work (kernel launches,
    asynchronous copies and sets) that start inside `intervals`."""
    ivs = union(intervals)
    starts = [s for s, _ in ivs]
    n = 0
    for name, s, _ in trace.host:
        if name.startswith(("cudaLaunch", "cuLaunch")) or (
                name.startswith(("cudaMem", "cuMem")) and
                name.endswith("Async")):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ivs[i][1]:
                n += 1
    return n


def pre_calls():
    """The profiled validation passes of the buffer (those with the
    producer's `val.pre` spans), oldest first, or None."""
    recorded = _recorded()
    if recorded is None:
        return None
    return [c for c in recorded()
            if any(s.name == "val.pre" for s in c.spans)]


def on_trace_clock(trace, call, name: str):
    """The call's buffer spans `name` as (start, end) on the trace's clock,
    placed by the call's anchor and the trace's one `side::anchor`."""
    anchors = side(trace, "anchor")
    if call.anchor is None or len(anchors) != 1:
        return None
    at_us = sum(anchors[0]) / 2
    at_ns = (call.anchor.start_ns + call.anchor.end_ns) / 2
    return [((s.start_ns - at_ns) / 1e3 + at_us,
             (s.end_ns - at_ns) / 1e3 + at_us)
            for s in call.spans if s.name == name]


def queue_waits_ms(call) -> list:
    """Per frame of the call: from the end of its `val.pre` to the start of
    its group's `val.dispatch` (the one with the largest first frame not
    after it), in ms."""
    dispatch = sorted((s.id, s.start_ns) for s in call.spans
                      if s.name == "val.dispatch")
    firsts = [i for i, _ in dispatch]
    out = []
    for s in call.spans:
        if s.name == "val.pre":
            k = bisect.bisect_right(firsts, s.id) - 1
            if k >= 0:
                out.append((dispatch[k][1] - s.end_ns) / 1e6)
    return out
