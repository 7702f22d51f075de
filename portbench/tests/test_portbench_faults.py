"""`correct` comes out false when the timed path is broken underneath: the
whole run on the CPU at a tiny size, the machine's look skipped, with each
fault a cell can have planted in the program, judged by the cell's own
limits.  A training cell can return its state unchanged, leave out half of
the batch, or alter an answer (the loss) where it is produced; a
validation pass holds no state that a step moves, so it can leave out half
of a group's answers or alter them, alter the device tail's depth where
the tail produces it, or choose its detections without the peak filter.  (The cells run on one chip: no
exchange between chips to leave out.)  And the control, the reference in
the program's place at the cell's control precision: at this size it
lies far from the reference where the program, at float32 on the CPU,
reads nothing; at the cell's own size, on the card, it fails the cell's
limits (test_portbench_card.py)."""

import numpy as np
import pytest
import torch

from portbench import calibrate, run
from portbench.tests.tiny import SEED, kind_of, overrides

TRAIN = ["train.side_dla34_cv.b4", "train.side_dla34_voxel.b4"]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _plant_train(monkeypatch, fault):
    from side_tpu_torch.runtime import trainer as T
    if fault == "state_unchanged":
        monkeypatch.setattr(T.Adam, "step", lambda self: 0.0)
    elif fault == "half_batch":
        full = T.Trainer.to_device

        def half(self, batch):
            b = full(self, batch)
            n = b["input"].shape[0] // 2
            return {k: v[:n] for k, v in b.items()}
        monkeypatch.setattr(T.Trainer, "to_device", half)
    elif fault == "answer_altered":
        loss = T.stereo_loss

        def altered(*a, **k):
            total, stats = loss(*a, **k)
            return total * 1.25, dict(stats, loss=stats["loss"] * 1.25)
        monkeypatch.setattr(T, "stereo_loss", altered)


def _plant_val(monkeypatch, fault):
    from side_tpu_torch.ops import decode as D
    from side_tpu_torch.postprocess import device_tail as T
    from side_tpu_torch.runtime.detector import Detector
    if fault == "tail_altered":
        tail = T._tail_batch

        def altered(*a, **k):
            rows, classes = tail(*a, **k)
            return torch.cat([rows[..., :10], rows[..., 10:11] * 1.1,
                              rows[..., 11:]], dim=-1), classes
        monkeypatch.setattr(T, "_tail_batch", altered)
        return
    if fault == "no_nms":
        monkeypatch.setattr(D, "nms_peaks", lambda heat, kernel=3: heat)
        return
    finish = Detector.finish_batch

    def planted(self, pending):
        outs = finish(self, pending)
        if fault == "half_batch":
            for o in outs[len(outs) // 2:]:
                o["results"] = {c: r[:0] for c, r in o["results"].items()}
        elif fault == "answer_altered":
            for o in outs:
                o["results"] = {c: r + np.float32(1.0)
                                for c, r in o["results"].items()}
        return outs
    monkeypatch.setattr(Detector, "finish_batch", planted)


FAULTS = [(w, f) for w in TRAIN
          for f in ("state_unchanged", "half_batch", "answer_altered")] + \
    [("val.side_dla34_cv.b8", f)
     for f in ("half_batch", "answer_altered", "tail_altered", "no_nms")]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_fault_fails(workload, fault, monkeypatch):
    kind = kind_of(workload)
    (_plant_train if kind == "train_loop" else _plant_val)(monkeypatch, fault)
    o = overrides(kind)
    out = run.run_cell(workload, SEED, 1.0, False, device="cpu", **o)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", TRAIN + ["val.side_dla34_cv.b8"])
def test_control_separates(workload):
    """Each of the cell's controls (its limits file names them) reads one
    of the numbers it is held by far above the program's own reading at
    this size, which is float32 on the CPU and so nearly nothing."""
    import json
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    kind = kind_of(workload)
    o = overrides(kind)
    prog = run.execute(workload, SEED, 0.5, False, device="cpu", **o)
    r = run.Run(bench, workload, SEED, 0, False, torch.device("cpu"), **o)
    readings = (calibrate.train_readings if kind == "train_loop"
                else calibrate.val_readings)(r, torch.device("cpu"))
    spec = json.load(open(f"{run.HERE}/limits/{workload}.json"))
    names = list(spec["limits"])
    assert all(prog.numbers[n] <= 1e-5 for n in names), prog.numbers
    for side, held in spec["controls"].items():
        assert any(readings[side][n] >= 100 * max(prog.numbers[n], 1e-6)
                   for n in held), (side, readings[side])
