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


def _record_runs(monkeypatch):
    """Spy on Detector.run: its inputs and results, per call."""
    from side_tpu_torch.runtime.detector import Detector
    calls = []
    run = Detector.run

    def spy(self, images, image_id=None, calib=None, run_align=True):
        seen = [np.array(im) for im in images]
        ret = run(self, images, image_id=image_id, calib=calib,
                  run_align=run_align)
        calls.append((seen, ret))
        return ret
    monkeypatch.setattr(Detector, "run", spy)
    return calls


def test_demo_debug_draws_the_jax_overlays(tmp_path, monkeypatch, capsys):
    """--debug 1 (tools/demo.py:93-103): the 3D boxes above vis_thresh on the
    left image and the bird's-eye view, saved as {idx}_*.png under the
    debug directory, equal to side_tpu's Debugger drawn on the port's
    detections (every decoded row kept: thresholds 0)."""
    from side_tpu.config import CLASS_NAMES as JCLASSES
    from side_tpu.utils.debugger import Debugger as JDebugger
    (left, right), calib, p2 = _write_pair(tmp_path)
    calls = _record_runs(monkeypatch)
    exp = tmp_path / "exp"
    rc = demo.main(["--demo", f"{left},{right}", "--calib", calib,
                    "--device", "cpu", "--debug", "1", "--peak_thresh", "0",
                    "--vis_thresh", "0", "--exp_dir", str(exp), *ARGS])
    assert rc == 0
    assert "overlays saved to" in capsys.readouterr().out
    debug_dir = exp / "stereo" / "default" / "debug"
    assert sorted(p.name for p in debug_dir.iterdir()) == \
        ["0_add_pred.png", "0_bird.png"]
    (_, ret), = calls
    assert sum(len(r) for r in ret["results"].values()) > 0
    ref = JDebugger(class_names=JCLASSES[1:])
    ref.add_3d_detection(cv2.imread(left), ret["results"], p2,
                         center_thresh=0.0)
    ref.add_bird_view(ret["results"], center_thresh=0.0)
    ref.save_all_imgs(str(tmp_path / "jax"), prefix="0_")
    for name in ("0_add_pred.png", "0_bird.png"):
        assert (debug_dir / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert (cv2.imread(str(debug_dir / "0_bird.png")) != 255).any()


def test_demo_debug_without_cv2_raises(tmp_path, monkeypatch):
    """--debug 1 needs OpenCV to draw: without it the demo says so before
    it builds the network (the JAX demo would save nothing)."""
    import sys
    from side_tpu_torch.runtime import detector
    (left, right), calib, _ = _write_pair(tmp_path)
    built = []
    monkeypatch.setattr(detector.Detector, "__init__",
                        lambda self, *a, **k: built.append(1))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match=r"OpenCV \(cv2\)"):
        demo.main(["--demo", f"{left},{right}", "--calib", calib,
                   "--device", "cpu", "--debug", "1", *ARGS])
    assert not built


def _write_video(path, frames):
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(f)
    out.release()


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            return frames
        frames.append(f)


def test_demo_video_pair_runs_frame_by_frame(tmp_path, monkeypatch, capsys):
    """A left,right .avi pair (tools/demo.py:55-74): frames read in step,
    one Detector.run each, up to the shorter stream; one stage line per
    frame; the rows equal Detector.run's on the same decoded frames."""
    from side_tpu_torch.runtime.detector import Detector
    (left, right), calib, _ = _write_pair(tmp_path)
    img_l, img_r = cv2.imread(left), cv2.imread(right)
    _write_video(tmp_path / "l.avi", [np.roll(img_l, 4 * i, axis=1)
                                      for i in range(3)])
    _write_video(tmp_path / "r.avi", [np.roll(img_r, 4 * i, axis=1)
                                      for i in range(2)])
    calls = _record_runs(monkeypatch)
    rc = demo.main(["--demo", f"{tmp_path / 'l.avi'},{tmp_path / 'r.avi'}",
                    "--calib", calib, "--device", "cpu", *ARGS])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    frame_lines = [ln for ln in lines if ln.startswith("frame ")]
    assert [ln.split(":")[0] for ln in frame_lines] == ["frame 0", "frame 1"]
    assert all(f"{st} " in frame_lines[0] for st in demo.STAGES)
    assert len(calls) == 2
    monkeypatch.undo()          # the reference runs below are not spied on
    lefts, rights = _read_video(tmp_path / "l.avi"), \
        _read_video(tmp_path / "r.avi")
    cfg = Config.cli(ARGS)
    det = Detector(cfg, device="cpu")
    calib_rows = read_calib_file(calib)
    for i, (images, ret) in enumerate(calls):
        np.testing.assert_array_equal(images[0], lefts[i])
        np.testing.assert_array_equal(images[1], rights[i])
        want = det.run([lefts[i], rights[i]], image_id=i, calib=calib_rows)
        assert sorted(ret["results"]) == sorted(want["results"])
        for cls, rows in want["results"].items():
            np.testing.assert_array_equal(ret["results"][cls], rows)


def test_create_model_raises_on_remat():
    """--remat rematerialises the backbone in side_tpu; the port's factory
    once refused it and now builds the flagship with its feature extractor
    checkpointed in training (tests/test_torch_flags.py holds the step):
    it raises nothing, and the model carries the flag."""
    from side_tpu_torch.models.factory import create_model
    cfg = Config.cli(["--remat", "--input_h", "128", "--input_w", "256"])
    assert cfg.remat
    assert create_model(cfg).remat is True
    assert create_model(Config.cli(["--input_h", "128", "--input_w",
                                    "256"])).remat is False
