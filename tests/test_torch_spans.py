"""The port's spans (side_tpu_torch/runtime/spans.py) on the CPU: the off
path records nothing and never fences; under torch.profiler the validation
pass, the device tail and the training loop show their `side::` ranges,
nested and ordered as the code runs them, the producer's `val.pre` spans
reach the buffer from their own thread, the buffer stays bounded, and no
result changes.  The small Detector is tests/test_torch_val.py's recipe."""

import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from side_tpu_torch import val as tval
from side_tpu_torch.config import Config
from side_tpu_torch.data.synthetic import scene_batch, val_scenes
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.runtime import spans
from side_tpu_torch.runtime.synthetic import interior_init
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import spread_detector

SMALL = dict(input_h=128, input_w=256, compute_dtype="float32", K=8,
             cv_topk=4, align_topk=4, peak_thresh=0.0)
MODES = {"b1": dict(eval_batch=1), "b2": dict(eval_batch=2),
         "serial": dict(serial=True)}
N_FRAMES = 5
TRAIN = dict(input_h=64, input_w=128, compute_dtype="float32", max_objs=8,
             roi_size=4, K=8, cv_topk=4, uncert=True, print_iter=1)
TRAIN_SPANS = ("train.data", "train.upload", "train.forward",
               "train.backward", "train.optimizer", "train.meters")


@pytest.fixture(scope="module")
def small_detector():
    return spread_detector(Config(**SMALL), seed=5)


@pytest.fixture(scope="module")
def scenes():
    return val_scenes(N_FRAMES, seed=2)


@pytest.fixture(autouse=True)
def _empty_buffer(monkeypatch):
    monkeypatch.setattr(spans, "_buffer",
                        collections.deque(maxlen=spans.CAPACITY))


def _pass(det, scenes, mode):
    return tval.run_pass(det.cfg, scenes, det, n=N_FRAMES, **MODES[mode])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _side_events(prof):
    """The `side::` events of the trace, as (name, start, end), by start;
    all of them from one thread."""
    side = [e for e in prof.events() if e.name.startswith("side::")]
    assert len({e.thread for e in side}) == 1
    return sorted(((e.name[len("side::"):], e.time_range.start,
                    e.time_range.end) for e in side), key=lambda x: x[1])


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _named(events, name):
    return [e for e in events if e[0] == name]


def _trainer(seed: int):
    cfg = Config(**TRAIN)
    model = create_model(cfg, seed=seed)
    interior_init(model, seed=seed + 10)
    return Trainer(cfg, model, steps_per_epoch=2, device="cpu")


def _batches(n: int):
    rng = np.random.RandomState(3)
    return [scene_batch(Config(**TRAIN), rng, 2, TRAIN["max_objs"])
            for _ in range(n)]


@pytest.fixture(scope="module")
def batches():
    return _batches(2)


# ------------------------------------------------------------- the off path
def test_off_span_is_one_shared_object_and_never_fences(monkeypatch):
    fences = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: fences.append(a))
    assert not torch.autograd._profiler_enabled()
    a, b = spans.span("x", 1), spans.span("y")
    assert a is b
    with a:
        pass
    assert spans.begin() is None
    with _cpu_profile():
        with spans.span("on", 3):
            pass
    assert fences == []
    assert [s.name for c in spans.recorded() for s in c.spans] == ["on"]


@pytest.mark.parametrize("mode", list(MODES))
def test_pass_off_records_nothing_and_on_changes_no_result(
        small_detector, scenes, mode):
    """No profiler: the buffer stays empty.  Under the profiler the same
    pass returns the same rows and meter counts."""
    results, meters, _ = _pass(small_detector, scenes, mode)
    assert spans.recorded() == []
    with _cpu_profile():
        got, got_meters, _ = _pass(small_detector, scenes, mode)
    assert spans.recorded()
    assert sorted(got) == sorted(results)
    for img_id in results:
        for cls in results[img_id]:
            np.testing.assert_array_equal(got[img_id][cls],
                                          results[img_id][cls])
    assert {k: m.count for k, m in got_meters.items()} == \
        {k: m.count for k, m in meters.items()}


def test_epoch_off_records_nothing_and_on_changes_no_result(batches):
    want = _trainer(4).run_epoch("train", 0, batches)
    assert spans.recorded() == []
    with _cpu_profile():
        got = _trainer(4).run_epoch("train", 0, batches)
    assert spans.recorded()
    assert {k: v for k, v in got.items() if k != "time"} == \
        {k: v for k, v in want.items() if k != "time"}


# --------------------------------------------------- the validation pass
@pytest.mark.parametrize("mode", ["b1", "b2"])
def test_pass_spans_nest_as_the_code_runs(small_detector, scenes, mode):
    with _cpu_profile() as prof:
        _pass(small_detector, scenes, mode)
    ev = _side_events(prof)
    B = MODES[mode]["eval_batch"]
    groups = -(-N_FRAMES // B)
    # a last full group leaves one more wait, which finds the end
    assert len(_named(ev, "val.wait_frames")) == \
        groups + (N_FRAMES % B == 0)
    for name in ("val.dispatch", "net", "decode", "tail",
                 "tail.prep", "tail.solve", "tail.align", "tail.resolve",
                 "val.finish", "val.wait_device", "val.fetch", "val.report"):
        assert len(_named(ev, name)) == groups, name
    assert len(_named(ev, "anchor")) == 1 and not _named(ev, "val.pre")
    for child, parent in (("tail.prep", "tail"), ("tail.solve", "tail"),
                          ("tail.align", "tail"), ("tail.resolve", "tail"),
                          ("tail", "val.dispatch"), ("net", "val.dispatch"),
                          ("decode", "val.dispatch"),
                          ("val.wait_device", "val.finish"),
                          ("val.fetch", "val.finish"),
                          ("val.report", "val.finish")):
        for c in _named(ev, child):
            assert _inside(c, _named(ev, parent)), (child, parent)
    for a, b in (("tail.prep", "tail.solve"), ("tail.solve", "tail.align"),
                 ("tail.align", "tail.resolve"),
                 ("val.wait_device", "val.fetch"),
                 ("val.fetch", "val.report")):
        for x, y in zip(_named(ev, a), _named(ev, b)):
            assert x[2] <= y[1], (a, b)
    # pipelined: group i is dispatched before group i-1 is finished
    dispatch, finish = _named(ev, "val.dispatch"), _named(ev, "val.finish")
    for i in range(1, groups):
        assert dispatch[i][2] <= finish[i - 1][1]


@pytest.mark.parametrize("mode", ["b1", "b2"])
def test_producer_spans_reach_the_buffer(small_detector, scenes, mode):
    """`val.pre` spans come from the producer's thread with the frame ids
    that the matching `val.dispatch` spans cover, each ended before its
    group's dispatch started."""
    main = threading.get_ident()
    with _cpu_profile():
        _pass(small_detector, scenes, mode)
    (call,) = spans.recorded()
    assert call.anchor is not None and call.anchor.thread == main
    pre = [s for s in call.spans if s.name == "val.pre"]
    dispatch = {s.id: s for s in call.spans if s.name == "val.dispatch"}
    assert sorted(s.id for s in pre) == list(range(N_FRAMES))
    assert main not in {s.thread for s in pre}
    B = MODES[mode]["eval_batch"]
    assert sorted(dispatch) == list(range(0, N_FRAMES, B))
    assert all(s.thread == main for s in call.spans if s.name != "val.pre")
    for s in pre:
        d = dispatch[max(i for i in dispatch if i <= s.id)]
        assert s.id - d.id < B and s.end_ns <= d.start_ns
    waits = [s.id for s in call.spans if s.name == "val.wait_frames"]
    assert waits == list(range(0, N_FRAMES, B)) + (
        [N_FRAMES] if N_FRAMES % B == 0 else [])


def test_buffer_stays_bounded(small_detector, scenes, monkeypatch):
    """A pass that records more entries than the buffer holds keeps the
    newest ones; the buffer does not grow."""
    small = collections.deque(maxlen=40)
    monkeypatch.setattr(spans, "_buffer", small)
    with _cpu_profile():
        _pass(small_detector, scenes, "b1")     # 14 spans a frame, 1 anchor
    assert len(small) == 40
    (call,) = spans.recorded()
    assert call.anchor is None and len(call.spans) == 40
    assert call.spans[-1].name == "val.finish"


# ---------------------------------------------------------- the training loop
def test_epoch_spans_one_of_each_per_step_in_order(batches):
    main = threading.get_ident()
    with _cpu_profile() as prof:
        _trainer(4).run_epoch("train", 0, batches)
    ev = [e for e in _side_events(prof) if e[0].startswith("train.")]
    steps = len(batches)
    # each step in turn, then the handout that ends the loop
    assert [e[0] for e in ev] == list(TRAIN_SPANS) * steps + ["train.data"]
    for x, y in zip(ev, ev[1:]):
        assert x[2] <= y[1], (x, y)
    assert not _named(ev, "train.allreduce")
    (call,) = spans.recorded()
    assert call.anchor is not None
    assert [s.id for s in call.spans if s.name == "train.data"] == \
        list(range(steps + 1))
    assert all(s.thread == main for s in call.spans)
