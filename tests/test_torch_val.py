"""The port's validation path: host tail, KITTI result files, evaluator,
`run_pass`, the val CLI, and the Detector's host-tail / re-dispatch routes.

`process_frame` is held against side_tpu's on the decode outputs of the
synthetic scene of tests/test_inference_tail.py, atol 1e-3 (the box solve
and the alignment amplify float noise).  The alignment picks a depth by
argmin over discrete steps: a RoI whose best two photometric errors in the
JAX package lie within 1e-4 (relative) may pick either and is left out of
the depth comparison, as in tests/test_torch_tail.py.
"""

import math
import os
import unittest.mock as um

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.data.synthetic import _render
from side_tpu.postprocess import dense_align as JDA
from side_tpu.postprocess import post_process as JPP
from side_tpu_torch import val as tval
from side_tpu_torch.config import CLASS_NAMES, Config
from side_tpu_torch.data.synthetic import val_scenes
from side_tpu_torch.postprocess import post_process as TPP
from side_tpu_torch.postprocess.device_tail import run_tail
from side_tpu_torch.runtime import evaluator as EV

from torch_parity import spread_detector
from test_inference_tail import CARS, DIM_HWL, _make_decode_outputs, _meta
from test_kitti_eval import _write_frames
from test_torch_tail import _jax_errors, _near_tie


def _scene(cars):
    cfg = JConfig()
    _, p2, p3 = _meta(cfg)
    objs = [{"type": "Car", "dim": list(DIM_HWL),
             "location": [c[0], c[1], c[2]], "rotation_y": c[3],
             "color": [200, 80, 60]} for c in cars]
    img_l = _render(objs, p2, np.random.RandomState(3))
    img_r = _render(objs, p3, np.random.RandomState(3))
    return cfg, img_l, img_r


def _tie_mask(args) -> np.ndarray:
    """Near-tie flags of the N detections of one JAX `align_depths` call
    (its positional arguments), coarse or fine stage."""
    im_l, im_r, f2, bl, cx2, cy2, box2, borders2, poses, valid = args
    fb = f2 * bl
    uv, has_span = JDA.sample_grid(box2, borders2)
    rays = jnp.stack([(uv[..., 0] - cx2) / f2, (uv[..., 1] - cy2) / f2], -1)
    dz, inside = jax.vmap(JDA.ray_box_intersect)(poses, rays)
    weight = (inside & has_span[:, None] & valid[:, None]).astype(jnp.float32)
    n = poses.shape[0]
    coarse = jnp.maximum(poses[:, 2][None] - 12.5 +
                         jnp.arange(50.0)[:, None] * 0.5, 1.5)
    e_c = _jax_errors(im_l, im_r, uv, dz, weight, coarse, fb)
    best = np.asarray(coarse)[np.argmin(e_c, 0), np.arange(n)]
    fine = jnp.asarray(best)[None] - 0.5 + jnp.arange(20.0)[:, None] * 0.05
    e_f = _jax_errors(im_l, im_r, uv, dz, weight, fine, fb)
    live = np.asarray(weight.sum(1) > 0)
    return (_near_tie(e_c) | _near_tie(e_f)) & live


# --------------------------------------------------------------- host tail
@pytest.mark.parametrize("run_align", [False, True],
                         ids=["solve", "solve_align"])
def test_process_frame_matches_jax(run_align):
    cars = CARS[:4]
    jcfg, img_l, img_r = _scene(cars)
    dets, dets_r, info, meta = _make_decode_outputs(
        jcfg, cars, depth_fn=lambda zz: zz + 1.5)
    captured = []
    real = JDA.align_depths

    def spy(*a):
        captured.append(a)
        return real(*a)

    with um.patch.object(JPP.DA, "align_depths", spy):
        want = JPP.process_frame(dets, dets_r, info, meta, jcfg, img_l,
                                 img_r, run_align=run_align)
    got = TPP.process_frame(dets, dets_r, info, meta, Config(), img_l, img_r,
                            run_align=run_align)
    assert set(got) == set(want) == {1, 2, 3}
    assert len(want[1]) == len(cars) and not len(want[2]) + len(want[3])
    for cls in want:
        assert got[cls].shape == want[cls].shape and \
            got[cls].dtype == np.float32
    ok = np.ones(len(cars), bool)
    if run_align:
        assert len(captured) == 1
        ok = ~_tie_mask(captured[0])[:len(cars)]
        assert ok.sum() >= 2
    # alpha, box, dim and score never depend on the argmin
    np.testing.assert_allclose(got[1][:, [0, 1, 2, 3, 4, 5, 6, 7, 12]],
                               want[1][:, [0, 1, 2, 3, 4, 5, 6, 7, 12]],
                               atol=1e-3)
    np.testing.assert_allclose(got[1][ok], want[1][ok], atol=1e-3, rtol=1e-5)


def test_process_frame_matches_the_device_tail():
    """Host tail and device tail of the port on one frame: the same rows
    (align_topk off, so both align every kept slot)."""
    cars = CARS[:3]
    jcfg, img_l, img_r = _scene(cars)
    cfg = Config(align_topk=0)
    dets, dets_r, info, meta = _make_decode_outputs(
        jcfg, cars, depth_fn=lambda zz: zz + 1.5)
    host = TPP.process_frame(dets, dets_r, info, meta, cfg, img_l, img_r)
    rows, classes = run_tail(torch.from_numpy(dets), torch.from_numpy(dets_r),
                             torch.from_numpy(info), img_l, img_r, meta, cfg)
    rows = rows.numpy()
    keep = rows[:, 12] > cfg.peak_thresh
    assert keep.sum() == len(cars) and (classes.numpy()[keep] == 0).all()
    np.testing.assert_allclose(host[1], rows[keep], atol=1e-3)
    # the alignment moved every depth off its +1.5 m start, the two near
    # cars back to within 0.5 m of the truth
    z_true = np.array([c[2] for c in cars])
    assert np.abs(host[1][:, 10] - (z_true + 1.5)).min() > 0.5
    assert np.abs(host[1][:2, 10] - z_true[:2]).max() < 0.5


def test_small_helpers_match_jax():
    rng = np.random.RandomState(0)
    cfg = JConfig()
    meta, _, _ = _meta(cfg)
    dets = np.abs(rng.randn(7, 6)).astype(np.float32) * 20
    info = rng.randn(7, 10).astype(np.float32)
    out = (cfg.output_w, cfg.output_h)
    jb = JPP.unwarp_boxes(dets, meta["c"], meta["s"], out)
    tb = TPP.unwarp_boxes(dets, meta["c"], meta["s"], out)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(TPP.cells_to_pixels(info, tb, cfg.grid),
                                  JPP.cells_to_pixels(info, jb, cfg.grid))
    np.testing.assert_array_equal(TPP.get_alpha(info[:, 3:5]),
                                  JPP.get_alpha(info[:, 3:5]))


def test_save_kitti_results_byte_equal(tmp_path):
    rng = np.random.RandomState(1)
    results = {i: {1: rng.randn(rng.randint(0, 4), 13).astype(np.float32) * 9,
                   2: np.zeros((0, 13), np.float32),
                   3: rng.randn(1, 13).astype(np.float32)}
               for i in (0, 3, 17)}
    jdir = JPP.save_kitti_results(results, str(tmp_path / "j"), CLASS_NAMES)
    tdir = TPP.save_kitti_results(results, str(tmp_path / "t"), CLASS_NAMES)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "000000.txt", "000003.txt", "000017.txt"]
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read()


# --------------------------------------------------------------- evaluator
@pytest.mark.parametrize("case", ["perfect", "shifted", "garbage"])
def test_evaluator_builds_runs_and_parses(tmp_path, case):
    seed, n, shift = {"perfect": (0, 150, 0.0), "shifted": (1, 150, 0.8),
                      "garbage": (2, 50, 25.0)}[case]
    gt_dir, res_dir = _write_frames(str(tmp_path), n,
                                    np.random.RandomState(seed), shift=shift)
    binary = EV.build_evaluator()
    assert binary.parent == EV.BUILD_DIR and os.access(binary, os.X_OK)
    aps = EV.run_eval(res_dir, gt_dir)
    for key in ("car_detection", "car_detection_ground", "car_detection_3d"):
        assert key in aps and len(aps[key]) == 3, aps
    if case == "perfect":
        assert all(aps[k][0] > 95.0 for k in aps), aps
    elif case == "shifted":
        assert aps["car_detection_3d"][0] < 30.0
        assert aps["car_detection"][0] < 30.0
    else:
        assert aps["car_detection_3d"][0] < 1.0
    assert os.path.isdir(os.path.join(str(tmp_path), "plot"))


def test_evaluator_failure_raises(tmp_path):
    gt_dir, res_dir = _write_frames(str(tmp_path), 2,
                                    np.random.RandomState(0))
    os.remove(os.path.join(gt_dir, "000001.txt"))
    with pytest.raises(RuntimeError, match="evaluator failed"):
        EV.run_eval(res_dir, gt_dir)
    assert EV.parse_ap("x\ncar_detection AP: 1.5 2.5 3.5\nsave y\n") == {
        "car_detection": (1.5, 2.5, 3.5)}


# ---------------------------------------------------------------- run_pass
SMALL = dict(input_h=128, input_w=256, compute_dtype="float32", K=8,
             cv_topk=4, align_topk=4, peak_thresh=0.0)


@pytest.fixture(scope="module")
def small_detector():
    return spread_detector(Config(**SMALL), seed=5)


@pytest.fixture(scope="module")
def passes(small_detector, tmp_path_factory):
    """run_pass over 5 in-memory scenes: eval_batch 1, 2 and serial."""
    det = small_detector
    scenes = val_scenes(5, seed=2)
    out = {}
    for name, kw in (("b1", dict(eval_batch=1)), ("b2", dict(eval_batch=2)),
                     ("serial", dict(serial=True))):
        results, meters, steady = tval.run_pass(det.cfg, scenes, det, n=5,
                                                **kw)
        d = str(tmp_path_factory.mktemp(name))
        TPP.save_kitti_results(results, d, CLASS_NAMES)
        out[name] = (results, meters, steady, os.path.join(d, "results"))
    return out


def test_run_pass_reports_every_frame_once(passes):
    for name, (results, meters, steady, res_dir) in passes.items():
        assert sorted(results) == [0, 1, 2, 3, 4], name
        assert meters["tot"].count == 5 and steady is not None and steady > 0
        assert sorted(os.listdir(res_dir)) == [f"{i:06d}.txt"
                                               for i in range(5)]
        n_rows = sum(len(r) for per in results.values() for r in per.values())
        assert n_rows == 5 * SMALL["K"]       # peak_thresh 0: every slot


@pytest.mark.parametrize("other", ["b2", "serial"])
def test_run_pass_modes_agree(passes, other):
    """The same result files from eval_batch 1, eval_batch 2 (3 groups, the
    last padded with a repeat of frame 4, whose copy is dropped) and the
    serial loop: rows to 1e-3, files line for line up to the last digit."""
    base, res = passes["b1"][0], passes[other][0]
    for img_id in base:
        for cls in base[img_id]:
            np.testing.assert_allclose(res[img_id][cls], base[img_id][cls],
                                       atol=1e-3, rtol=1e-4)
    for name in os.listdir(passes["b1"][3]):
        with open(os.path.join(passes["b1"][3], name)) as a, \
                open(os.path.join(passes[other][3], name)) as b:
            la, lb = a.read().split(), b.read().split()
        assert len(la) == len(lb)
        for va, vb in zip(la, lb):
            if va != vb:
                assert abs(float(va) - float(vb)) <= 0.011, (name, va, vb)


def test_run_pass_num_images_and_producer_failure(small_detector):
    det = small_detector
    scenes = val_scenes(3, seed=2)
    results, _, steady = tval.run_pass(det.cfg, scenes, det, n=2,
                                       eval_batch=2, no_align=True)
    assert sorted(results) == [0, 1] and steady is None
    bad = scenes[:1] + [(1, ("/nonexistent/l.png", "/nonexistent/r.png"),
                         scenes[0][2])]
    with pytest.raises((FileNotFoundError, RuntimeError)):
        tval.run_pass(det.cfg, bad, det, n=2, eval_batch=2)


# --------------------------------------------------------------------- CLI
def _cli_args(tmp_path):
    return ["stereo", "--synthetic_scenes", "3", "--eval_batch", "2",
            "--input_h", "128", "--input_w", "256", "--K", "8",
            "--compute_dtype", "float32", "--exp_dir", str(tmp_path),
            "--dcn_fused"]


def test_val_cli_end_to_end_on_cpu(tmp_path, capsys):
    from side_tpu_torch.ops import deform_conv as tdc
    prev = tdc.get_dcn_fused()
    try:
        assert tval.main(_cli_args(tmp_path) + ["--device", "cpu"]) == 0
        assert tdc.get_dcn_fused()
    finally:
        tdc.set_dcn_fused(prev)
    out = capsys.readouterr().out
    save = tmp_path / "stereo" / "default"
    assert sorted(os.listdir(save / "results")) == [
        "000000.txt", "000001.txt", "000002.txt"]
    assert sorted(os.listdir(save / "synthetic_gt" / "label_2")) == [
        "000000.txt", "000001.txt", "000002.txt"]
    assert "[val] batch 2: wall" in out and "[val] running:" in out
    assert (save / "plot").is_dir()          # the evaluator ran
    assert "[3/3] 000002" in out


def test_val_cli_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.main(_cli_args(tmp_path))


# ------------------------------------------- Detector: the three satellites
def test_finish_redispatches_when_run_align_changes(small_detector):
    det = small_detector
    _, pair, calib = val_scenes(1, seed=3)[0]
    aligned = det.finish(det.dispatch(det.load_and_pre(pair, calib), True))
    plain = det.finish(det.dispatch(det.load_and_pre(pair, calib), False))
    pending = det.dispatch(det.load_and_pre(pair, calib), run_align=True)
    with um.patch.object(det, "dispatch", wraps=det.dispatch) as spy:
        same = det.finish(pending, run_align=True)
        assert spy.call_count == 0
        changed = det.finish(pending, run_align=False)
        assert spy.call_count == 1
        assert spy.call_args.kwargs == {"run_align": False}
    for cls in aligned["results"]:
        np.testing.assert_array_equal(same["results"][cls],
                                      aligned["results"][cls])
        np.testing.assert_array_equal(changed["results"][cls],
                                      plain["results"][cls])


def test_host_tail_route(small_detector, monkeypatch):
    """SIDE_TPU_TORCH_HOST_TAIL=1: dispatch stops after the decode and
    finish runs `process_frame`; the rows equal the device tail's where both
    align (the device tail aligns the top align_topk slots only)."""
    det = small_detector
    _, pair, calib = val_scenes(1, seed=4)[0]
    device = det.finish(det.dispatch(det.load_and_pre(pair, calib)))
    monkeypatch.setenv("SIDE_TPU_TORCH_HOST_TAIL", "1")
    pending = det.dispatch(det.load_and_pre(pair, calib))
    assert pending["fused"] is False and len(pending["handles"]) == 3
    with um.patch("side_tpu_torch.runtime.detector.process_frame",
                  wraps=TPP.process_frame) as spy:
        host = det.finish(pending)
        assert spy.call_count == 1
    monkeypatch.delenv("SIDE_TPU_TORCH_HOST_TAIL")
    top = SMALL["align_topk"]
    slot_class = pending["handles"][0][0, :, 5].numpy().astype(int)
    n = 0
    for cls in (1, 2, 3):
        # this class's rows keep the decode order: which are top-`top` slots
        aligned = np.flatnonzero(slot_class == cls - 1) < top
        np.testing.assert_allclose(host["results"][cls][aligned],
                                   device["results"][cls][aligned],
                                   atol=1e-3, rtol=1e-4)
        cols = [0, 1, 2, 3, 4, 5, 6, 7, 12]     # never moved by alignment
        np.testing.assert_allclose(host["results"][cls][:, cols],
                                   device["results"][cls][:, cols],
                                   atol=1e-3)
        n += aligned.sum()
    assert n == top


@pytest.mark.parametrize("kind", [tuple, list])
def test_load_and_pre_takes_paths_as_tuple_or_list(small_detector, tmp_path,
                                                   kind):
    cv2 = pytest.importorskip("cv2")
    det = small_detector
    _, (img_l, img_r), calib = val_scenes(1, seed=5)[0]
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    cv2.imwrite(lp, img_l)
    cv2.imwrite(rp, img_r)
    from_paths = det.load_and_pre(kind([lp, rp]), calib)
    from_arrays = det.load_and_pre(kind([img_l, img_r]), calib)
    np.testing.assert_array_equal(from_paths["image"], img_l)
    for k in ("input", "input_right"):
        assert torch.equal(from_paths["batch"][k], from_arrays["batch"][k])
