"""The port's batched tail and batched Detector path.

`run_tail_batch` (one tail over a frame axis) against side_tpu's
`run_tail_batch` and against the port's own `run_tail` frame by frame, on
the three frames of differing true size of
tests/test_inference_tail.py::test_device_tail_batched_matches_single, atol
1e-3 (the box solve and the alignment amplify float noise), classes equal.
`Detector.dispatch_batch` / `finish_batch` against `dispatch` / `finish` on
the CPU with shared weights.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.data.synthetic import _render
from side_tpu.postprocess.device_tail import run_tail_batch as j_run_tail_batch
from side_tpu_torch.config import Config
from side_tpu_torch.postprocess.device_tail import (_pad_stack,
                                                    bucket_results, run_tail,
                                                    run_tail_batch)

from torch_parity import spread_detector
from test_inference_tail import CARS, DIM_HWL, _make_decode_outputs, _meta


def _frames():
    cfg = JConfig()
    _, p2, p3 = _meta(cfg)
    frames = []
    for j, cars in enumerate([CARS[:2], CARS[2:4], CARS[1:3]]):
        objs = [{"type": "Car", "dim": list(DIM_HWL),
                 "location": [c[0], c[1], c[2]], "rotation_y": c[3],
                 "color": [200, 80, 60]} for c in cars]
        img_l = _render(objs, p2, np.random.RandomState(j))
        img_r = _render(objs, p3, np.random.RandomState(j))
        crop_h, crop_w = img_l.shape[0] - 2 * j, img_l.shape[1] - 5 * j
        img_l, img_r = img_l[:crop_h, :crop_w], img_r[:crop_h, :crop_w]
        dets, dets_r, info, meta = _make_decode_outputs(
            cfg, cars, depth_fn=lambda zz: zz + 1.5)
        frames.append((dets, dets_r, info, img_l, img_r, meta))
    return cfg, frames


@pytest.fixture(scope="module")
def batched():
    jcfg, frames = _frames()
    stack = lambda i: np.stack([f[i] for f in frames])
    lists = ([f[3] for f in frames], [f[4] for f in frames],
             [f[5] for f in frames])
    rows, classes = run_tail_batch(
        *(torch.from_numpy(stack(i)) for i in range(3)), *lists, Config(),
        run_align=True)
    return jcfg, frames, stack, lists, rows.numpy(), classes.numpy()


def test_run_tail_batch_matches_jax(batched):
    jcfg, frames, stack, lists, rows, classes = batched
    j_rows, j_classes = j_run_tail_batch(
        *(jnp.asarray(stack(i)) for i in range(3)), *lists, jcfg,
        run_align=True)
    j_rows = np.asarray(j_rows)
    np.testing.assert_array_equal(classes, np.asarray(j_classes))
    assert rows.shape == j_rows.shape == (3, jcfg.K, 13)
    assert np.isfinite(j_rows[:, :2]).all()
    np.testing.assert_allclose(rows[:, :2], j_rows[:, :2], atol=1e-3)
    fin = np.isfinite(j_rows)
    assert (fin == np.isfinite(rows)).all()
    np.testing.assert_allclose(rows[fin], j_rows[fin], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_run_tail_batch_matches_single_frame(batched, i):
    """Frames edge-padded to the group's extent give what each gives alone
    at its true size."""
    _, frames, _, _, rows, classes = batched
    dets, dets_r, info, img_l, img_r, meta = frames[i]
    rows_1, classes_1 = run_tail(
        torch.from_numpy(dets), torch.from_numpy(dets_r),
        torch.from_numpy(info), img_l, img_r, meta, Config(), run_align=True)
    np.testing.assert_array_equal(classes[i], classes_1.numpy())
    np.testing.assert_allclose(rows[i], rows_1.numpy(), atol=1e-3,
                               equal_nan=True)


def test_run_tail_batch_without_alignment(batched):
    jcfg, frames, stack, lists, rows, _ = batched
    got, _ = run_tail_batch(
        *(torch.from_numpy(stack(i)) for i in range(3)), *lists, Config(),
        run_align=False)
    want, _ = j_run_tail_batch(
        *(jnp.asarray(stack(i)) for i in range(3)), *lists, jcfg,
        run_align=False)
    np.testing.assert_allclose(got.numpy()[:, :2], np.asarray(want)[:, :2],
                               atol=1e-3)
    # the alignment moved the depth of the aligned rows
    assert np.abs(got.numpy()[:, :2, 10] - rows[:, :2, 10]).max() > 0.2


def test_pad_stack_and_bucket_results():
    from side_tpu.postprocess.device_tail import _pad_stack as j_pad_stack
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((7, 11), (5, 9), (7, 8))]
    np.testing.assert_array_equal(_pad_stack(imgs, 7, 11),
                                  j_pad_stack(imgs, 7, 11))
    rows = rng.randn(6, 13).astype(np.float32)
    classes = np.array([0, 2, 1, 0, 2, 2])
    keep = np.array([1, 1, 0, 1, 0, 1], bool)
    out = bucket_results(rows, classes, keep, 3)
    assert sorted(out) == [1, 2, 3]
    np.testing.assert_array_equal(out[1], rows[[0, 3]])
    assert len(out[2]) == 0
    np.testing.assert_array_equal(out[3], rows[[1, 5]])


def test_dispatch_batch_matches_dispatch():
    """Three frames of differing size through one batched pass against the
    same frames one by one, shared weights, CPU, f32."""
    from side_tpu_torch.data.synthetic import val_scenes
    cfg = Config(input_h=128, input_w=256, compute_dtype="float32", K=12,
                 cv_topk=6, align_topk=6, peak_thresh=0.0)
    det = spread_detector(cfg, seed=3)
    scenes = val_scenes(3, seed=1)
    pairs = [(l[:l.shape[0] - 2 * j, :l.shape[1] - 4 * j],
              r[:r.shape[0] - 2 * j, :r.shape[1] - 4 * j])
             for j, (_, (l, r), _) in enumerate(scenes)]
    calib = scenes[0][2]
    singles = [det.finish(det.dispatch(det.load_and_pre(p, calib)))
               for p in pairs]
    pending = det.dispatch_batch([det.load_and_pre(p, calib) for p in pairs])
    assert tuple(pending["handles"][0].shape) == (3, cfg.K, 13)
    outs = det.finish_batch(pending)
    assert len(outs) == 3
    n = 0
    for one, many in zip(singles, outs):
        assert set(one["results"]) == set(many["results"]) == {1, 2, 3}
        for cls, rows in one["results"].items():
            assert many["results"][cls].shape == rows.shape
            np.testing.assert_allclose(many["results"][cls], rows, atol=1e-3,
                                       rtol=1e-4)
            n += len(rows)
        for k in ("tot", "load", "pre", "net", "dec", "post", "merge"):
            assert many[k] >= 0
    assert n == 3 * cfg.K
