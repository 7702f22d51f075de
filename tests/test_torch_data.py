"""The port's host data pipeline against side_tpu's: the copies must give
equal arrays.

Targets from rendered scenes, flipped and not, focal and MSE heatmaps;
`StereoKitti` samples on the synthetic fixture with every augmentation on
(scale/shift, color, stereo flip), uint8 and float images, from the same
seeds; the COCO-JSON conversion; the seeded, shuffled `Loader`; and the
in-memory `scene_batch` the card runs train on.  Everything is NumPy on
both sides, so the tolerance is equality.
"""

import numpy as np
import pytest

from side_tpu.config import Config as JConfig
from side_tpu.data import dataset as jds
from side_tpu.data import geometry as jgeo
from side_tpu.data import kitti as jk
from side_tpu.data import loader as jloader
from side_tpu.data import synthetic as jsyn
from side_tpu.data import targets as jtg
from side_tpu_torch.config import Config
from side_tpu_torch.data import dataset as tds
from side_tpu_torch.data import geometry as tgeo
from side_tpu_torch.data import kitti as tk
from side_tpu_torch.data import loader as tloader
from side_tpu_torch.data import synthetic as tsyn
from side_tpu_torch.data import targets as ttg

CLASSES = ["Car", "Van", "Truck"]
CAT_TO_ID = {"__background__": -1, "Car": 0, "Van": 1, "Truck": 2}


def _assert_same(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        if k == "meta":
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (where, k)
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{where} {k}")


def _scene(seed, recipe):
    rng = np.random.RandomState(seed)
    objs = jsyn.make_scene(rng, 3, recipe=recipe,
                           classes=("Car", "Van", "Truck"))
    p2, p3 = jsyn.default_calib()
    p0 = p2.copy()
    p0[0, 3] = 0.0
    calib = [p0.tolist(), p3.tolist(), p2.tolist(), p3.tolist()]
    return objs, p2, calib


@pytest.mark.parametrize("recipe", ["easy", "occluded", "truncated"])
@pytest.mark.parametrize("flipped,mse", [(False, False), (True, True)],
                         ids=["plain", "flipped_mse"])
def test_generate_targets_equal(recipe, flipped, mse):
    objs, p2, calib = _scene(3, recipe)
    anns = tsyn.scene_annotations(objs, p2)
    shape = (jsyn.IMG_H, jsyn.IMG_W, 3)
    trans = jgeo.get_affine_transform(
        np.array([621.0, 187.5]), np.array([1242.0, 375.0]), 0, [80, 24])
    want = jtg.generate_targets(
        jk.read_objects(anns, calib, CLASSES, shape), CAT_TO_ID, trans,
        jtg.TargetSpec(output_w=80, output_h=24, max_objs=8, mse_loss=mse),
        flipped=flipped, img_w=jsyn.IMG_W)
    got = ttg.generate_targets(
        tk.read_objects(anns, calib, CLASSES, shape), CAT_TO_ID, trans,
        ttg.TargetSpec(output_w=80, output_h=24, max_objs=8, mse_loss=mse),
        flipped=flipped, img_w=jsyn.IMG_W)
    _assert_same(got, want)
    assert want["rot_mask"].sum() >= 1


def test_scene_annotations_equal_convert_split(fixture_root):
    """The port's label parser (shared by convert_split and scene_batch)
    against the JAX package's convert_split on the fixture."""
    import os
    base = os.path.join(fixture_root, "kitti")
    for split in ("train", "val"):
        assert tk.convert_split(base, "3dop", split) == \
            jk.convert_split(base, "3dop", split)


@pytest.mark.parametrize("uint8_images", [True, False],
                         ids=["uint8", "float"])
def test_stereo_kitti_samples_equal(fixture_root, uint8_images):
    kw = dict(data_dir=fixture_root, input_h=96, input_w=320, aug_ddd=1.0,
              flip_train=True, uint8_images=uint8_images)
    jd = jds.StereoKitti(JConfig(**kw), "train")
    td = tds.StereoKitti(Config(**kw), "train")
    assert len(td) == len(jd) == 8
    for i in range(len(jd)):              # 4 plain, then 4 stereo-flipped
        want, got = jd[i], td[i]
        _assert_same(got, want, f"sample {i}")
        for k in ("img_id", "image_path", "flipped"):
            assert got["meta"][k] == want["meta"][k]
        np.testing.assert_array_equal(got["meta"]["s"], want["meta"]["s"])
    assert got["meta"]["flipped"]


def test_loader_batches_equal(fixture_root):
    kw = dict(data_dir=fixture_root, input_h=64, input_w=128)
    jl = jloader.Loader(jds.StereoKitti(JConfig(**kw), "train"), 2,
                        shuffle=True, num_workers=1, drop_last=True, seed=5)
    tl = tloader.Loader(tds.StereoKitti(Config(**kw), "train"), 2,
                        shuffle=True, num_workers=1, drop_last=True, seed=5)
    assert len(tl) == len(jl) == 2
    for epoch in range(2):
        for got, want in zip(tl, jl):
            _assert_same(got, want, f"epoch {epoch}")


def test_color_aug_equal():
    rng = np.random.RandomState(0)
    img = rng.rand(20, 30, 3).astype(np.float32)
    a, b = img.copy(), img.copy()
    jgeo.color_aug(np.random.RandomState(1), a, jds._EIG_VAL, jds._EIG_VEC)
    tgeo.color_aug(np.random.RandomState(1), b, tds._EIG_VAL, tds._EIG_VEC)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, img)


def test_scene_batch_is_a_seeded_training_batch():
    """scene_batch: StereoKitti's keys and dtypes, targets in range, same
    seed same batch; its scenes are the fixture generator's."""
    cfg = Config(input_h=64, input_w=128)
    a = tsyn.scene_batch(cfg, np.random.RandomState(7), 3, 6)
    b = tsyn.scene_batch(cfg, np.random.RandomState(7), 3, 6)
    _assert_same(a, b)
    assert a["input"].shape == (3, 64, 128, 3) and a["input"].dtype == np.uint8
    assert a["hm"].shape == (3, 3, 16, 32) and a["ind"].shape == (3, 6)
    valid = a["rot_mask"].astype(bool)
    assert valid.any(axis=1).all()
    assert (a["depth"][valid] > 0).all() and (a["depth"][~valid] == 0).all()
    assert (a["ind"] < 16 * 32).all()
    np.testing.assert_allclose(a["fb"], jsyn.F * jsyn.BASELINE, rtol=1e-6)


@pytest.mark.parametrize("out_hw,max_share", [((128, 384), 0.0),
                                              ((384, 1280), 1e-3)],
                         ids=["128x384", "384x1280"])
def test_warp_affine_fallback_rounds_as_cv2(monkeypatch, out_hw, max_share):
    """Without OpenCV (the H100 machine) the NumPy warp rounds, as
    cv2.warpAffine does: equal at the protocol's 128x384, within 1 LSB on
    at most 0.1 % of the pixels at 384x1280 (cv2 interpolates in fixed
    point)."""
    import cv2
    h, w = out_hw
    diffs = []
    for sc in tsyn.fixture_scenes(4, 0, seed=0):
        for img in (sc["left"], sc["right"]):
            c = np.array([img.shape[1] / 2.0, img.shape[0] / 2.0])
            s = np.array([img.shape[1], img.shape[0]], np.float64)
            trans = tgeo.get_affine_transform(c, s, 0, [w, h])
            want = cv2.warpAffine(img, trans[:2].astype(np.float64), (w, h),
                                  flags=cv2.INTER_LINEAR)
            with monkeypatch.context() as m:
                m.setattr(tds, "_cv2", lambda: None)
                got = tds.warp_affine(img, trans, w, h)
            assert got.dtype == np.uint8 and got.shape == want.shape
            diffs.append(np.abs(got.astype(np.int16) - want))
    diffs = np.stack(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= max_share
