"""On the card: one short run of each cell through the command line, with
`correct` true, and each cell's control at the cell's own size failing the
cell's limits.  Skips without a CUDA device (decided in the fixture)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(card, workload):
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_card(card, workload):
    import torch
    from portbench import calibrate
    from portbench.check import judge
    spec = json.load(open(os.path.join(run.HERE, "limits",
                                       f"{workload}.json")))
    r = run.Run(BENCH, workload, 2147483671, 0, False, torch.device("cuda"))
    readings = (calibrate.train_readings if r.mix["kind"] == "train_loop"
                else calibrate.val_readings)(r, torch.device("cuda"))
    for side in spec["controls"]:
        assert judge(readings[side], spec["limits"])[0] is False, \
            (side, readings[side])
