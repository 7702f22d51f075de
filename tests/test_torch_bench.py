"""side_tpu_torch.bench on the CPU: the small configuration (64x128, f32,
3 chained iterations; training 1 and 2 steps).

- The result line has exactly bench.py's keys; BENCH_SKIP_TRAIN=1 drops
  the training figure.
- The chain is real: the second call's input differs from the first's by
  1e-6 times the first call's top score, and the first call's is the
  example input.
- A failing training figure ends `main` with the error and no result line
  (bench.py swallows it); without a CUDA device the default device
  raises.
- `--train-only B` takes the training figure alone, at B pairs, and
  prints it; the serving figure is not taken.
"""

import json

import pytest
import torch

from side_tpu_torch import bench
from side_tpu_torch.graft_entry import served

import torch_parity  # noqa: F401  (thread count)

KEYS = {"metric", "value", "unit", "vs_baseline"}


def _result(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_result_line_has_the_jax_keys(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_SKIP_TRAIN", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    out = _result(capsys)
    assert set(out) == KEYS | {"train_pairs_per_sec_per_chip"}
    assert out["metric"] == "kitti_stereo_infer_pairs_per_sec_per_chip"
    assert out["unit"] == "stereo_pairs/s"
    assert out["value"] > 0 and out["train_pairs_per_sec_per_chip"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] * 0.031,
                                               abs=1e-3)


def test_skip_train_drops_the_training_figure(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SKIP_TRAIN", "1")

    def never(*a, **kw):
        raise AssertionError("training figure taken under BENCH_SKIP_TRAIN")
    monkeypatch.setattr(bench, "train_pairs_per_s", never)
    assert bench.main(["--device", "cpu"]) == 0
    assert set(_result(capsys)) == KEYS


def test_the_chain_feeds_each_call_the_previous_score():
    fn, (model, pair) = served(bench.CPU_KW, torch.float32, "cpu")
    batch = bench.repeat_pairs(pair, 2)
    seen = []

    def spy(model, b):
        seen.append(b["input"].clone())
        out = fn(model, b)
        seen.append(out[0][0, 0, 4])
        return out
    scores = bench.chained(spy, model, batch, 2)
    (x0, s0), (x1, s1) = seen[0:2], seen[2:4]
    assert torch.equal(x0, batch["input"])
    assert not torch.equal(x1, x0)
    assert torch.equal(x1, batch["input"] + s0 * 1e-6)
    assert torch.equal(scores, torch.stack([s0, s1]))


def test_a_failing_training_figure_fails_the_run(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_SKIP_TRAIN", raising=False)

    def broken(*a, **kw):
        raise RuntimeError("training step failed")
    monkeypatch.setattr(bench, "train_pairs_per_s", broken)
    with pytest.raises(RuntimeError, match="training step failed"):
        bench.main(["--device", "cpu"])
    assert "metric" not in capsys.readouterr().out


def test_train_only_prints_the_training_figure_alone(monkeypatch, capsys):
    def never(*a, **kw):
        raise AssertionError("serving figure taken under --train-only")
    monkeypatch.setattr(bench, "serving_pairs_per_s", never)
    sizes = []
    real = bench.train_pairs_per_s

    def spy(batch_size, *a, **kw):
        sizes.append(batch_size)
        return real(batch_size, *a, **kw)
    monkeypatch.setattr(bench, "train_pairs_per_s", spy)
    assert bench.main(["--device", "cpu", "--train-only", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sizes == [1]
    assert len(lines) == 1 and float(lines[0]) > 0


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
