"""On the card: the program's spans put nothing on the device's timeline.
For one training step of `train.side_dla34_cv.b4` and one validation group
of `val.side_dla34_cv.b8` (full size, seeded random weights), under both
modes of metrics/trace.py:profile_call (device activity only; with the
host's): no device event carries a `side::` name or is a user annotation,
the device events are as many as with the spans forced off, every span the
readers read is among the host events, and the spans also record under
device activity alone.  The device events of one step or group are
compared as the most of three runs on each side, within SPREAD: the
profiler's own count moves by a few between identical runs, spans on or
off alike (a group's 12,969 read 12,968 in some runs; two host-traced
groups 25,930-25,938), while a span that reached the device would add one
event per span, 8 a step and 15 a group here.  Skips without a CUDA device
(decided in the fixture).

    python -m pytest --noconftest -p no:cacheprovider -q \\
        portbench/tests/test_portbench_spans_card.py
"""

import contextlib
import json
import os

import pytest
import torch

from portbench import run
from portbench.metrics.trace import profile_call

SEED = 2147483677
SPANS = {
    "train": ("anchor", "train.data", "train.upload", "train.forward",
              "train.backward", "train.optimizer", "train.meters"),
    "val": ("anchor", "val.wait_frames", "val.dispatch", "net", "decode",
            "tail", "tail.prep", "tail.solve", "tail.align", "tail.resolve",
            "val.finish", "val.wait_device", "val.fetch", "val.report"),
}
BUFFER_ONLY = {"train": (), "val": ("val.pre",)}   # the producer's thread
SPREAD = 4      # device events: the profiler's run-to-run spread, measured
CELLS = {"train": "train.side_dla34_cv.b4", "val": "val.side_dla34_cv.b8"}


def build(work: str, workload: str = None, n: int = 1):
    """(n steps or groups of `workload` as a function, its device): the
    benchmark's configuration and traffic at full size, one batch or group
    of frames repeated."""
    from portbench.drivers.train_loop import _Batches
    from portbench.drivers.val_pass import _Frames
    from portbench.traffic import generator
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.trainer import Trainer
    from side_tpu_torch.val import run_pass

    bench = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    device = torch.device("cuda")
    r = run.Run(bench, workload or CELLS[work], SEED, 0, True, device)
    if work == "train":
        keys = dict(r.config_keys, batch_size=int(r.mix["pairs_per_step"]))
        pool = generator.train_pool(r.ref_config(keys),
                                    dict(r.mix, pool_batches=1), SEED)
        cfg = Config(**keys)
        tr = Trainer(cfg, create_model(cfg).to(device), steps_per_epoch=1,
                     device=device)

        def fn():
            tr.run_epoch("train", 0, _Batches(pool, 0, n=n))
    else:
        keys = dict(r.config_keys)
        B = int(r.mix["eval_batch"])
        pool = generator.val_pool(r.ref_config(keys),
                                  dict(r.mix, pool_frames=B), SEED)
        cfg = Config(**keys)
        det = Detector(cfg, device=device)

        def fn():
            with open(os.devnull, "w") as quiet, \
                    contextlib.redirect_stdout(quiet):
                run_pass(cfg, _Frames(pool, 0, n=n * B), det, n=n * B,
                         eval_batch=B)
    fn()
    fn()
    torch.cuda.synchronize(device)
    return fn, device


@contextlib.contextmanager
def spans_forced_off():
    """The span helper as if no profiler ran: nothing recorded."""
    from side_tpu_torch.runtime import spans
    real = spans._profiler_enabled
    spans._profiler_enabled = lambda: False
    try:
        yield
    finally:
        spans._profiler_enabled = real


def traced(fn, device, host: bool, monkeypatch):
    """profile_call's Trace of fn() and the profiler's own events."""
    kept = []

    class Keep(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(list(self.events()))
            return out

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "profile", Keep)
        t = profile_call(fn, device, host=host)
    return t, kept[0]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def built(card):
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("work", ["train", "val"])
def test_spans_add_no_device_event(built, work, host, monkeypatch):
    from side_tpu_torch.runtime import spans
    if work not in built:
        built[work] = build(work)
    fn, device = built[work]
    counts = {True: [], False: []}
    for on in (True, False, False, True, True, False):
        before = len(spans.recorded())
        with contextlib.nullcontext() if on else spans_forced_off():
            t_side, events = traced(fn, device, host, monkeypatch)
        counts[on].append(len(t_side.kernels))
        calls = spans.recorded()
        if not on:
            assert len(calls) == before
            t_off = t_side
            continue
        t = t_side
        on_device = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        assert on_device
        assert not [e.name for e in on_device
                    if e.name.startswith("side::")]
        assert not [e.name for e in on_device
                    if getattr(e, "is_user_annotation", False)]
        # the gate sees the profiler in either mode: one new call, anchored
        assert len(calls) == before + 1 and calls[-1].anchor is not None
        call = calls[-1]
    assert abs(max(counts[True]) - max(counts[False])) <= SPREAD, counts
    assert {s.name for s in call.spans} >= \
        set(SPANS[work][1:] + BUFFER_ONLY[work])
    if host:
        names = {n for n, _, _ in t.host}
        assert {"side::" + s for s in SPANS[work]} <= names
        assert not {n for n, _, _ in t_off.host if n.startswith("side::")}
