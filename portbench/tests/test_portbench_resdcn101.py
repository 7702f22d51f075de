"""The committed `train.side_resdcn101.b4` on the CPU at the tiny size, and
its two trunk span metrics on a hand-built trace.

The cell: its configuration at resdcn_101's published depth with `reduced`
empty, `correct` with every compared number nearly nothing; each fault of
a training cell planted in the program (test_portbench_faults.py's), judged
by the cell's own limits, and the cell's controls.  The readers
`trunk_launches_per_step.train` and `idle_in_trunk.train`: their values
on the trace of test_portbench_spans.py with the model's spans added, per
step over two forwards, and None where the trace has no `net.trunk` (the
DLA cells, a program whose model predates the span) or the program no
spans module."""

import json
import math
import os
import sys

import pytest
import torch

from portbench import run
from portbench.metrics import reader
from portbench.metrics.trace import Trace
from portbench.tests.test_portbench_faults import (
    _plant_train, test_control_separates as _control_separates)
from portbench.tests.test_portbench_spans import (  # noqa: F401 (fixture)
    KERNELS, TRAIN_HOST, buffer)
from portbench.tests.tiny import SEED, overrides
from side_tpu_torch.runtime import spans as program

WORKLOAD = "train.side_resdcn101.b4"
BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
TRUNK = ("idle_in_trunk.train", "trunk_launches_per_step.train")
# the model's spans inside train.forward (0-15 us): the trunk over 2-12
# with two enqueue calls, the up-stages over 12-13 with one; one more call
# in the backward.  Device idle 10-20 and 30-50 (30 us): 2 us of it in
# the trunk.
NET_HOST = TRAIN_HOST + [
    ("side::net.trunk", 2.0, 12.0), ("side::net.up", 12.0, 13.0),
    ("cudaLaunchKernel", 3.0, 4.0), ("cudaMemsetAsync", 11.0, 11.5),
    ("cudaLaunchKernel", 12.5, 12.6), ("cudaLaunchKernel", 20.0, 21.0)]


@pytest.fixture
def threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _train(host):
    return {"kind": "train_loop", "device": "cuda",
            "trace_host": Trace(KERNELS, host, 60.0)}


def test_committed_resdcn101_cell(threads):
    """`correct` with every compared number <= 1e-5, three finite single
    layers, the heatmap's last bias -2.1875 and its 3x3 conv's 0."""
    from portbench import weights
    from portbench.reference import model as ref_model
    cell = {w["name"]: w for w in BENCH["workloads"]}[WORKLOAD]
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    keys = json.load(open(os.path.join(run.ROOT, conf["file"])))
    assert conf["reduced"] == keys["reduced"] == [] and cell["chips"] == 1
    assert (keys["config"]["arch"], keys["config"]["head_conv"],
            keys["config"]["cost_volume"]) == ("resdcn_101", 64, False)
    r = run.execute(WORKLOAD, SEED, 0.5, False, device="cpu",
                    **overrides("train_loop"))
    out = r.result()
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)
    layers = r.compared[0]["layers"]
    assert sorted(layers) == ["dcn", "head", "stem"]
    assert all(math.isfinite(v) and v <= 1e-5 for v in layers.values())
    meta = ref_model.build(r.ref_config(r.config_keys))
    assert len(meta.trunk.names) == 33 and meta.trunk.out_channels == 2048
    w = weights.draw(meta, SEED, "cpu")
    assert w["hm_out.bias"].tolist() == [-2.1875] * 3
    assert w["hm_conv.bias"].abs().max().item() == 0.0


# A loss altered where it is produced shows in loss_gap_1 alone (Adam's
# step does not see a scale), and this cell's limits hold no loss_gap_1:
# its random ResNet-101 amplifies bfloat16's rounding of the first loss as
# much as fp8's (PERF.md, section 7).  The hole stays in the report until
# a compared number catches it.
@pytest.mark.parametrize("fault", [
    "state_unchanged", "half_batch",
    pytest.param("answer_altered", marks=pytest.mark.xfail(
        strict=True, reason="the cell's limits hold no loss_gap_1 "
                            "(PERF.md, section 7)"))])
def test_fault_fails(threads, monkeypatch, fault):
    _plant_train(monkeypatch, fault)
    out = run.run_cell(WORKLOAD, SEED, 1.0, False, device="cpu",
                       **overrides("train_loop"))
    assert out["correct"] is False, out["checks"]


def test_control_separates(threads):
    _control_separates(WORKLOAD)


def test_trunk_readers_read_the_known_values(buffer):
    assert reader("idle_in_trunk.train")(_train(NET_HOST)) == \
        pytest.approx(100 * 2 / 30)
    assert reader("trunk_launches_per_step.train")(_train(NET_HOST)) == 2


def test_trunk_launches_count_per_step(buffer):
    """Two steps: the trunk's enqueue calls over the number of forwards;
    calls outside the trunk (the up-stages, the backward) do not count."""
    host = NET_HOST + [
        ("side::train.forward", 36.0, 39.0), ("side::net.trunk", 36.5, 38.0),
        ("cudaLaunchKernel", 37.0, 37.1), ("cudaLaunchKernel", 37.5, 37.6),
        ("cudaMemcpyAsync", 37.8, 37.9), ("cudaStreamSynchronize", 37.9, 38.0),
        ("cudaLaunchKernel", 38.5, 38.6)]
    assert reader("trunk_launches_per_step.train")(_train(host)) == \
        pytest.approx((2 + 3) / 2)
    # idle 30-50 overlaps the second trunk over 36.5-38: 1.5 us more
    assert reader("idle_in_trunk.train")(_train(host)) == \
        pytest.approx(100 * (2 + 1.5) / 30)


@pytest.mark.parametrize("name", TRUNK)
def test_trunk_reader_none_without_the_trunk_span(buffer, name):
    """A training trace with every span of the loop but no `net.trunk`: a
    DLA cell, or a program whose model predates the span."""
    d = _train(TRAIN_HOST)
    assert reader("idle_in_forward.train")(d) is not None
    assert reader(name)(d) is None


@pytest.mark.parametrize("name", TRUNK)
def test_trunk_reader_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(program, "recorded", lambda: [])
    d = _train([h for h in NET_HOST if not h[0].startswith("side::")])
    assert reader(name)(d) is None
    assert reader(name)({}) is None
    other = _train(NET_HOST)
    other["device"] = "cpu"
    assert reader(name)(other) is None
    monkeypatch.setitem(sys.modules, "side_tpu_torch.runtime.spans", None)
    assert reader(name)(_train(NET_HOST)) is None
