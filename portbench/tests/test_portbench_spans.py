"""The span readers (metrics/spans.py and the nine `program_span` metrics
that read the program's spans) on a hand-built trace and buffer with known
gaps; each returns None where the trace has no `side::` events and where
the program has no spans module; the anchor moves buffer spans onto the
profiler's clock."""

import collections
import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import reader
from portbench.metrics import spans as S
from portbench.metrics.trace import Trace
from side_tpu_torch.runtime import spans as program

# device busy 0-10, 20-30, 50-60 us: idle 10-20 and 30-50, 30 us in all
KERNELS = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0)]
VAL_HOST = [
    ("side::anchor", 100.0, 102.0),
    ("side::val.dispatch", 4.0, 26.0), ("side::val.dispatch", 48.0, 49.0),
    ("side::tail", 5.0, 25.0),
    ("cudaLaunchKernel", 6.0, 7.0), ("cudaLaunchKernel", 12.0, 13.0),
    ("cudaMemcpyAsync", 15.0, 16.0), ("cudaStreamSynchronize", 16.0, 17.0),
    ("cudaLaunchKernel", 26.0, 27.0), ("aten::mul", 12.0, 14.0),
    ("side::val.wait_frames", 35.0, 45.0),
    ("side::val.finish", 28.0, 40.0),
]
TRAIN_HOST = [
    ("side::train.forward", 0.0, 15.0), ("side::train.backward", 15.0, 35.0),
    ("side::train.data", 40.0, 45.0), ("side::train.upload", 45.0, 48.0),
    ("side::train.optimizer", 52.0, 55.0),
    ("side::train.meters", 55.0, 60.0),
]
A_NS = (1_000_000, 1_002_000)       # the buffer's anchor; midpoint 101 us


def _span(name, id, start_ns, end_ns, thread=1):
    return program.Span(name, id, thread, int(start_ns), int(end_ns))


def _ns(us):
    """A time on the trace's clock (us) as the buffer's ns."""
    return (us - 101.0) * 1e3 + sum(A_NS) / 2


def _calls():
    first = program.Call(_span("anchor", None, 0, 1), [
        _span("val.pre", 0, 0, 1e6, 2), _span("val.pre", 1, 0, 2e6, 2),
        _span("val.pre", 2, 0, 6e6, 2), _span("val.dispatch", 0, 4e6, 5e6),
        _span("val.dispatch", 2, 7e6, 8e6)])
    last = program.Call(_span("anchor", None, *A_NS), [
        _span("val.pre", 0, _ns(30.0), _ns(40.0), 2),
        _span("val.dispatch", 0, _ns(4.0), _ns(26.0))])
    return [first, program.Call(None, [_span("train.data", 0, 0, 1)]), last]


def _val(host=VAL_HOST):
    return {"kind": "val_pass", "device": "cuda",
            "trace_host": Trace(KERNELS, host, 60.0)}


def _train(host=TRAIN_HOST):
    return {"kind": "train_loop", "device": "cuda",
            "trace_host": Trace(KERNELS, host, 60.0)}


@pytest.fixture
def buffer(monkeypatch):
    monkeypatch.setattr(program, "recorded", _calls)


WANT = {
    "idle_in_tail.val": (_val, 100 * 10 / 30),
    "tail_launches_per_group.val": (_val, 3 / 2),
    "idle_in_wait_frames.val": (_val, 100 * 10 / 30),
    "idle_in_finish.val": (_val, 100 * 10 / 30),
    "idle_during_pre.val": (_val, 100 * 10 / 30),
    "queue_wait_ms.val": (_val, 2.0),
    "idle_in_forward.train": (_train, 100 * 5 / 30),
    "idle_in_backward.train": (_train, 100 * 10 / 30),
    "idle_outside_passes.train": (_train, 100 * 8 / 30),
}


@pytest.mark.parametrize("name", list(WANT))
def test_reader_reads_the_known_value(buffer, name):
    make, want = WANT[name]
    assert reader(name)(make()) == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("name", list(WANT))
def test_reader_none_without_spans(monkeypatch, name):
    make, _ = WANT[name]
    monkeypatch.setattr(program, "recorded", lambda: [])
    d = make(host=[h for h in VAL_HOST + TRAIN_HOST
                   if not h[0].startswith("side::")])
    assert reader(name)(d) is None
    assert reader(name)({}) is None
    other = make()
    other["device"] = "cpu"
    assert reader(name)(other) is None


@pytest.mark.parametrize("name", list(WANT))
def test_reader_none_without_the_spans_module(monkeypatch, name):
    """A program that predates the spans: the import fails."""
    monkeypatch.setitem(sys.modules, "side_tpu_torch.runtime.spans", None)
    make, _ = WANT[name]
    assert reader(name)(make()) is None


def test_intervals_by_hand():
    assert S.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert S.idle(Trace(KERNELS, [], 0)) == [(10.0, 20.0), (30.0, 50.0)]
    assert S.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.idle_share(Trace(KERNELS[:1], [], 0), [(0, 5)]) is None


def test_anchor_puts_buffer_spans_on_the_trace_clock(monkeypatch):
    """Under the CPU profiler: a main-thread span's buffer entry, moved by
    its call's anchor, lands on its own profiler event."""
    monkeypatch.setattr(program, "_buffer", collections.deque(maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program.begin()
        time.sleep(0.002)
        with program.span("x", 7):
            time.sleep(0.005)
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]
    t = Trace([], host, 0.0)
    (moved,) = S.on_trace_clock(t, program.recorded()[-1], "x")
    ((s, e),) = S.side(t, "x")
    assert abs(moved[0] - s) < 50 and abs(moved[1] - e) < 50
