"""`--reference_exact` in the port: the JAX package's rule
(side_tpu/config.py: the flag sets exact DCN mode for the process unless
SIDE_TPU_DCN pins one; a checkpoint whose radius differs only warns).

- Training: `train.train`, which every rank runs, trains in exact mode and
  tags its checkpoint `meta::dcn_radius` -1, in one process and in the
  ranks `train.main --num_devices 2` spawns; SIDE_TPU_TORCH_DCN=windowed
  keeps the window (tag 1).
- Serving: the Detector under the flag stays exact on an R = 1 checkpoint
  and warns, and stays windowed under SIDE_TPU_TORCH_DCN=windowed on an
  exact one; the demo serves exact through it.  Without the flag the
  Detector still switches to the checkpoint's radius (the port's settled
  default).

The DCN mode is process state: every test starts from a mode it sets and
gives the prior one back (`dcn_mode`).
"""

import sys

import numpy as np
import pytest

from side_tpu_torch import demo, train, weights
from side_tpu_torch.config import Config
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime import checkpoint
from side_tpu_torch.runtime.detector import Detector
from side_tpu_torch.runtime.trainer import Trainer

import torch_parity  # noqa: F401  (thread count)
from test_torch_demo import _write_pair

SMALL = ["--input_h", "64", "--input_w", "128", "--K", "8",
         "--compute_dtype", "float32"]


def _train_argv(fixture_root, tmp_path, *extra):
    return ["stereo", "--data_dir", fixture_root, "--exp_dir", str(tmp_path),
            "--batch_size", "2", "--num_epochs", "1", "--num_iters", "1",
            "--val_intervals", "0", "--num_workers", "1", *SMALL, *extra]


def _saved_radius(tmp_path) -> int:
    path = tmp_path / "stereo" / "default" / "model_last.npz"
    with np.load(path) as data:
        return int(data["meta::dcn_radius"])


def _spy_train_steps(monkeypatch):
    """The DCN radius tag in force at each training step."""
    seen = []
    step = Trainer.train_step

    def spy(self, batch):
        seen.append(tdc.dcn_radius_tag())
        return step(self, batch)
    monkeypatch.setattr(Trainer, "train_step", spy)
    return seen


def _no_tensorboard(monkeypatch):
    # the optional TensorBoard writer imports TensorFlow here (~20 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.mark.parametrize("pinned, radius", [(None, -1), ("windowed", 1)],
                         ids=["flag", "env_pins_windowed"])
def test_training_follows_the_flag(fixture_root, tmp_path, monkeypatch,
                                   pinned, radius):
    _no_tensorboard(monkeypatch)
    if pinned is None:
        monkeypatch.delenv("SIDE_TPU_TORCH_DCN", raising=False)
    else:
        monkeypatch.setenv("SIDE_TPU_TORCH_DCN", pinned)
    seen = _spy_train_steps(monkeypatch)
    cfg = Config.cli(_train_argv(fixture_root, tmp_path,
                                 "--reference_exact")).replace(roi_size=4)
    with tdc.dcn_mode("windowed", 1):
        assert train.train(cfg, "cpu") == 0
    assert seen == [radius]
    assert _saved_radius(tmp_path) == radius


def test_spawned_ranks_train_exact(fixture_root, tmp_path, monkeypatch):
    """`--num_devices 2 --device cpu --reference_exact`: the ranks, new
    processes started in windowed mode, train exact and rank 0 tags its
    checkpoint -1.  (A `tensorboard` package on sys.path that fails to
    import keeps the ranks from importing TensorFlow.)"""
    monkeypatch.delenv("SIDE_TPU_TORCH_DCN", raising=False)
    cli = train.Config.cli
    monkeypatch.setattr(train.Config, "cli", staticmethod(
        lambda argv=None: cli(argv).replace(roi_size=4)))
    _no_tensorboard(monkeypatch)
    stub = tmp_path / "no_tensorboard" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        'raise ImportError("TensorBoard is blocked in this test")\n')
    monkeypatch.syspath_prepend(str(stub.parent))
    argv = _train_argv(fixture_root, tmp_path, "--reference_exact",
                       "--device", "cpu", "--num_devices", "2")
    with tdc.dcn_mode("windowed", 1):
        assert train.main(argv) == 0
        assert tdc.dcn_radius_tag() == 1        # the parent is untouched
    assert _saved_radius(tmp_path) == -1


def _checkpoint(tmp_path, radius: int) -> str:
    """A small model's checkpoint tagged `radius`."""
    cfg = Config.cli(SMALL)
    params, stats = weights.to_flax(create_model(cfg).state_dict())
    path = str(tmp_path / f"r{radius}.npz")
    with tdc.dcn_mode("windowed", 1):
        tdc.set_dcn_radius_tag(radius)
        checkpoint.save_checkpoint(path, 1, params, stats)
    return path


@pytest.mark.parametrize("pinned, stored, radius", [
    (None, 1, -1), ("windowed", -1, 1)], ids=["flag", "env_pins_windowed"])
def test_detector_keeps_the_mode_and_warns(tmp_path, monkeypatch, capsys,
                                           pinned, stored, radius):
    if pinned is None:
        monkeypatch.delenv("SIDE_TPU_TORCH_DCN", raising=False)
    else:
        monkeypatch.setenv("SIDE_TPU_TORCH_DCN", pinned)
    path = _checkpoint(tmp_path, stored)
    cfg = Config.cli([*SMALL, "--reference_exact", "--load_model", path])
    capsys.readouterr()
    with tdc.dcn_mode("windowed", 1):
        Detector(cfg, device="cpu")
        assert tdc.dcn_radius_tag() == radius
    out = capsys.readouterr().out
    assert "WARNING: checkpoint trained with DCN" in out
    assert "switching" not in out


def test_detector_without_the_flag_switches(tmp_path, capsys):
    path = _checkpoint(tmp_path, 1)
    cfg = Config.cli([*SMALL, "--load_model", path])
    capsys.readouterr()
    with tdc.dcn_mode("exact"):
        Detector(cfg, device="cpu")
        assert (tdc.get_dcn_mode(), tdc.dcn_radius_tag()) == ("windowed", 1)
    assert "switching to windowed R=1" in capsys.readouterr().out


def test_demo_serves_exact_on_a_windowed_checkpoint(tmp_path, monkeypatch):
    monkeypatch.delenv("SIDE_TPU_TORCH_DCN", raising=False)
    seen = []
    network = Detector.network

    def spy(self, batch):
        seen.append(tdc.dcn_radius_tag())
        return network(self, batch)
    monkeypatch.setattr(Detector, "network", spy)
    (left, right), calib, _ = _write_pair(tmp_path)
    path = _checkpoint(tmp_path, 1)
    with tdc.dcn_mode("windowed", 1):
        assert demo.main(["--demo", f"{left},{right}", "--calib", calib,
                          "--device", "cpu", *SMALL, "--reference_exact",
                          "--load_model", path]) == 0
    assert seen == [-1]
