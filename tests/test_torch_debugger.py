"""The port's Debugger against side_tpu's: every method, on the same seeded
detections, heatmaps and calibration, draws the same pixels (tolerance 0:
the same OpenCV calls), and the saved PNGs are byte-equal.  Where cv2 is
missing the port's Debugger raises, naming it."""

import sys

import cv2
import numpy as np
import pytest

from side_tpu.utils.debugger import Debugger as JDebugger
from side_tpu_torch.data.synthetic import default_calib
from side_tpu_torch.utils import debugger as tdebugger
from side_tpu_torch.utils.debugger import Debugger

import torch_parity  # noqa: F401  (thread count)

H, W = 376, 1240      # the calibration's image (default_calib)


def _results(rng, n_per_class=4):
    """{cls: rows [alpha, box4, h, w, l, x, y, z, ry, score]}: cars in front
    of the camera, scores across the threshold, one box straddling the
    image plane (its corners behind z = 0.1 are skipped)."""
    out = {}
    for cls in (1, 2, 3):
        rows = np.zeros((n_per_class, 13))
        rows[:, 0] = rng.uniform(-np.pi, np.pi, n_per_class)
        rows[:, 1:3] = rng.uniform(0, 150, (n_per_class, 2))
        rows[:, 3:5] = rows[:, 1:3] + rng.uniform(10, 60, (n_per_class, 2))
        rows[:, 5:8] = rng.uniform([1.4, 1.5, 3.5], [2.5, 2.2, 8.0],
                                   (n_per_class, 3))
        rows[:, 8] = rng.uniform(-12, 12, n_per_class)
        rows[:, 9] = rng.uniform(1.4, 1.8, n_per_class)
        rows[:, 10] = rng.uniform(6, 45, n_per_class)
        rows[:, 11] = rng.uniform(-np.pi, np.pi, n_per_class)
        rows[:, 12] = rng.uniform(0.05, 0.95, n_per_class)
        out[cls] = rows
    out[1][0, 10] = 0.5      # near the camera: some corners at z < 0.1
    out[1][0, 12] = 0.9
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    heat = rng.uniform(0, 1, (3, H // 4, W // 4)).astype(np.float32)
    dets = np.concatenate([rng.uniform([0, 0, 5, 5, 0.0], [W, H, 80, 50, 1.0],
                                       (12, 5)),
                           rng.randint(0, 3, (12, 1))], axis=1)
    kpts = np.concatenate([rng.uniform(0, W, (6, 3)),
                           rng.randint(0, 4, (6, 1)),
                           rng.uniform(0, H, (6, 1))], axis=1)
    p2, _ = default_calib()
    return {"img": img, "heat": heat, "dets": dets, "kpts": kpts,
            "kpts4": kpts[:, :4], "p2": p2, "results": _results(rng),
            "gts": _results(np.random.RandomState(1), 3)}


def _draw(dbg, inp, tmp_path):
    """Every drawing method once, on both canvases kinds."""
    color = dbg.gen_colormap(inp["heat"])
    color_hwc = dbg.gen_colormap(inp["heat"].transpose(1, 2, 0))
    dbg.add_img(inp["img"], "img")
    dbg.add_blend_img(inp["img"], color, "blend")
    dbg.add_blend_img(inp["img"], color[::2, ::2].copy(), "blend_resized",
                      trans=0.4)
    dbg.add_ct_detection(inp["img"], inp["dets"], center_thresh=0.3)
    dbg.add_ct_detection(inp["img"], inp["dets"], show_box=False,
                         img_id="centres")
    dbg.add_kept(inp["kpts"])
    dbg.add_kept(inp["kpts4"], img_id="centres", color=(0, 255, 0))
    dbg.add_kept(inp["kpts"], img_id="absent")
    dbg.add_3d_detection(inp["img"], inp["results"], inp["p2"])
    path = str(tmp_path / "left.png")
    cv2.imwrite(path, inp["img"])
    dbg.add_3d_detection(path, inp["results"], inp["p2"].ravel(),
                         center_thresh=0.0, img_id="from_path")
    dbg.add_bird_view(inp["results"])
    dbg.add_bird_views(inp["results"], inp["gts"], center_thresh=0.5,
                       img_id="birds")
    dark = type(dbg)(theme="black")
    dark.add_bird_view(inp["results"], img_id="bird_black")
    dbg.imgs["bird_black"] = dark.imgs["bird_black"]
    return color, color_hwc


def test_every_method_draws_the_same_pixels(inputs, tmp_path):
    port, ref = Debugger(), JDebugger()
    got = _draw(port, inputs, tmp_path)
    want = _draw(ref, inputs, tmp_path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(port.imgs) == list(ref.imgs)
    for name in ref.imgs:
        assert port.imgs[name].dtype == ref.imgs[name].dtype, name
        np.testing.assert_array_equal(port.imgs[name], ref.imgs[name],
                                      err_msg=name)
    # the overlays drew something
    assert not np.array_equal(port.imgs["add_pred"], inputs["img"])
    assert (port.imgs["bird"] != 255).any()


def test_saved_pngs_are_byte_equal(inputs, tmp_path):
    port, ref = Debugger(), JDebugger()
    _draw(port, inputs, tmp_path)
    _draw(ref, inputs, tmp_path)
    port.save_all_imgs(str(tmp_path / "port"), prefix="3_")
    ref.save_all_imgs(str(tmp_path / "jax"), prefix="3_")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "3_add_pred.png" in names and "3_bird.png" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_show_all_imgs_shows_the_same(inputs, tmp_path, monkeypatch):
    shown = []
    monkeypatch.setattr(cv2, "imshow",
                        lambda name, img: shown.append((name, img.copy())))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: shown.append(ms))
    for cls in (Debugger, JDebugger):
        dbg = cls()
        _draw(dbg, inputs, tmp_path)
        dbg.show_all_imgs(pause=True)
    half = len(shown) // 2
    assert half > 1 and shown[half - 1] == 0 and shown[-1] == 0
    for a, b in zip(shown[:half - 1], shown[half:-1]):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


def test_debugger_raises_without_cv2(monkeypatch):
    """The JAX copy draws nothing without cv2; the port says so."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match=r"OpenCV \(cv2\)"):
        Debugger()
    with pytest.raises(RuntimeError, match="cv2"):
        tdebugger.require_cv2()
