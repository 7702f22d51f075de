"""The port's demo CLI end to end on the CPU: PNG pair and KITTI calib txt
in, one line of stage times and a detection count out; and the port's own
handling of `--reference_exact`."""

import cv2
import numpy as np
import pytest
import torch

from side_tpu.data.synthetic import _render, default_calib, make_scene
from side_tpu_torch import demo
from side_tpu_torch.config import Config
from side_tpu_torch.data.kitti import read_calib_file

import torch_parity  # noqa: F401  (thread count)

ARGS = ["--input_h", "128", "--input_w", "256", "--K", "20"]


def _write_pair(tmp_path):
    p2, p3 = default_calib()
    objs = make_scene(np.random.RandomState(0), 2)
    paths = []
    for name, p in (("left.png", p2), ("right.png", p3)):
        path = tmp_path / name
        cv2.imwrite(str(path), _render(objs, p, np.random.RandomState(5)))
        paths.append(str(path))
    calib = tmp_path / "calib.txt"
    p0 = p2.copy()
    p0[0, 3] = 0.0
    rows = [("P0", p0), ("P1", p3), ("P2", p2), ("P3", p3),
            ("R0_rect", np.eye(3))]
    calib.write_text("".join(
        f"{k}: " + " ".join(f"{v:.6e}" for v in np.ravel(m)) + "\n"
        for k, m in rows))
    return paths, str(calib), p2


def test_demo_runs_one_pair_on_cpu(tmp_path, capsys):
    (left, right), calib, p2 = _write_pair(tmp_path)
    np.testing.assert_allclose(np.array(read_calib_file(calib)[2]), p2,
                               rtol=1e-6)
    rc = demo.main(["--demo", f"{left},{right}", "--calib", calib,
                    "--device", "cpu", *ARGS])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("left.png: tot ")
    assert "detections above peak_thresh=0.2" in out


def test_demo_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (left, right), calib, _ = _write_pair(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--demo", f"{left},{right}", "--calib", calib, *ARGS])


def test_cli_reference_exact_without_a_dcn_import():
    cfg = Config.cli(["--reference_exact"])
    assert (cfg.reference_exact, cfg.cv_topk, cfg.align_topk,
            cfg.depth_aux_weight, cfg.uint8_images) == (True, 0, 0, 0.0,
                                                        False)
    default = Config.cli([])
    assert (default.cv_topk, default.align_topk, default.K,
            default.input_h, default.input_w) == (32, 32, 100, 384, 1280)


def test_demo_debug_overlays_exit_with_a_message(capsys):
    """--debug 1 draws overlays in tools/demo.py; the port has no drawing
    yet, so it says so instead of ignoring the flag."""
    with pytest.raises(SystemExit, match="overlay drawing .* not ported"):
        demo.main(["--debug", "1"])
    with pytest.raises(SystemExit, match="--demo left.png"):
        demo.main(["--debug", "0"])


def test_create_model_raises_on_remat():
    """--remat rematerialises the backbone in side_tpu; the port's factory
    refuses it rather than run the full footprint without a word."""
    from side_tpu_torch.models.factory import create_model
    cfg = Config.cli(["--remat", "--input_h", "128", "--input_w", "256"])
    assert cfg.remat
    with pytest.raises(NotImplementedError, match="--remat"):
        create_model(cfg)
