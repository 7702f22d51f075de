"""The port's acceptance protocol against the JAX package's.

- The fixture held in memory (`data/synthetic.py:fixture_scenes`,
  `FixtureKitti`, `fixture_frames`) against `build_fixture`'s tree read by
  the JAX package's `StereoKitti`: every training sample, every frame, the
  COCO split, the label files and the image ids, array for array and byte
  for byte.
- `save_and_eval` against the JAX `_save_and_eval` of
  tests/test_overfit_ap.py for each of the 4 variants, on one set of
  results made from the GT labels (with noise, one object missing and one
  of the wrong class): equal APs, per-object errors to 1e-12.
- The summary lines and `summary.json` against tools/acceptance_16.py's
  `main` on the same canned protocol output, and the floors (`floors_16`,
  `floors_2`) against the assertions of the JAX tests themselves.
- The tool end to end on the CPU at a tiny size (2 scenes, 2 epochs,
  64x192, f32); `acceptance_rate`'s depth fit on that run's checkpoint and
  its lines on canned protocol outputs.
Under `slow`: the 2-scene protocol on the CPU, its trained checkpoint read
by the JAX package's Detector, and its floors.
"""

import copy
import importlib
import json
import math
import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from side_tpu.config import Config as JConfig
from side_tpu.data.dataset import StereoKitti as JStereoKitti
from side_tpu.data.loader import Loader as JLoader
from side_tpu.data.synthetic import build_fixture
from side_tpu_torch.data.loader import Loader
from side_tpu_torch.data.synthetic import (FixtureKitti, fixture_coco,
                                           fixture_frames, fixture_scenes)
from side_tpu_torch.tools import acceptance_16 as acc
from side_tpu_torch.tools import acceptance_rate as rate

import torch_parity  # noqa: F401  (thread count)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCENES = 16
PROTOCOL = dict(input_h=128, input_w=384, batch_size=4, lr=1e-3,
                lr_step=(10 ** 9,), max_objs=16, K=16, aug_ddd=0.0,
                no_color_aug=True, flip_train=False,
                compute_dtype="float32", num_devices=1, uncert=False,
                peak_thresh=0.25)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """build_fixture's 16 + 2 scene tree, as the JAX protocol writes it."""
    root = str(tmp_path_factory.mktemp("acc16"))
    build_fixture(root, n_train=N_SCENES, n_val=2, seed=0)
    return root


@pytest.fixture(scope="module")
def scenes():
    return fixture_scenes(n_train=N_SCENES, n_val=2, seed=0)[:N_SCENES]


def _jcfg(root):
    return JConfig(data_dir=root, **PROTOCOL)


def _tcfg(root="data"):
    return acc.protocol_config(root, "exp", (128, 384), 4)


def _assert_samples_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        if k == "meta":
            continue
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, \
            (where, k)
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{where} {k}")


def test_protocol_config_is_the_jax_protocols(tree):
    jcfg, tcfg = _jcfg(tree), acc.protocol_config(tree, "exp", (128, 384), 4)
    for k, v in PROTOCOL.items():
        assert getattr(tcfg, k) == v == getattr(jcfg, k), k
    assert tcfg.seed == jcfg.seed


def test_fixture_samples_equal_stereo_kitti(tree, scenes):
    """Every training sample of the in-memory split equals the JAX
    StereoKitti's over the tree, in order (one random stream each)."""
    want = JStereoKitti(_jcfg(tree), "train")
    got = FixtureKitti(_tcfg(), scenes)
    assert len(got) == len(want) == N_SCENES
    assert got.images == want.images == list(range(N_SCENES))
    for i in range(N_SCENES):
        a, b = got[i], want[i]
        _assert_samples_equal(a, b, f"sample {i}")
        assert a["meta"]["img_id"] == b["meta"]["img_id"] == i
        assert a["meta"]["calib"] == b["meta"]["calib"]
        np.testing.assert_array_equal(a["meta"]["c"], b["meta"]["c"])
        np.testing.assert_array_equal(a["meta"]["s"], b["meta"]["s"])


def test_fixture_loader_batches_equal(tree, scenes):
    """One shuffled epoch of the protocol's Loader, as both packages
    build it."""
    want = JLoader(JStereoKitti(_jcfg(tree), "train"), 4, shuffle=True,
                   num_workers=2, drop_last=True, seed=0)
    got = Loader(FixtureKitti(_tcfg(), scenes), 4, shuffle=True,
                 num_workers=2, drop_last=True, seed=0)
    n = 0
    for a, b in zip(got, want):
        _assert_samples_equal(a, b, f"batch {n}")
        n += 1
    assert n == len(got) == len(want) == N_SCENES // 4


def test_fixture_split_equals_convert_split(tree, scenes):
    with open(os.path.join(tree, "kitti", "annotations_3d",
                           "kitti_3dop_train.json")) as f:
        want = json.load(f)
    assert fixture_coco(scenes) == want


def test_fixture_frames_equal_the_tree(tree, scenes, tmp_path):
    """Frames: the PNGs' arrays, the ids and calibration StereoKitti gives
    the detector; label files byte-equal to the tree's."""
    ds = JStereoKitti(_jcfg(tree), "train")
    label_dir = tmp_path / "label_2"
    frames = fixture_frames(scenes, str(label_dir))
    assert [f[0] for f in frames] == ds.images
    for img_id, (left, right), calib in frames:
        info = ds.coco.images[img_id]
        np.testing.assert_array_equal(
            left, cv2.imread(os.path.join(ds.img_dir, info["file_name"])))
        np.testing.assert_array_equal(
            right, cv2.imread(os.path.join(ds.img_right_dir,
                                           info["file_name"])))
        assert calib == info["calib"]
        name = f"{img_id:06d}.txt"
        assert (label_dir / name).read_bytes() == open(os.path.join(
            tree, "kitti", "training", "label_2", name), "rb").read()
    assert len(os.listdir(label_dir)) == N_SCENES


def test_build_fixture_writes_the_jax_tree(tree, tmp_path):
    """The port's build_fixture (now over fixture_scenes) writes the JAX
    package's tree: the same files, byte for byte."""
    from side_tpu_torch.data.synthetic import build_fixture as tbuild
    tbuild(str(tmp_path), n_train=N_SCENES, n_val=2, seed=0)
    for sub in ("training/label_2", "training/calib", "ImageSets_3dop",
                "annotations_3d", "training/image_2", "training/image_3"):
        a = os.path.join(tree, "kitti", sub)
        b = os.path.join(str(tmp_path), "kitti", sub)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)), sub
        for name in os.listdir(a):
            if name.endswith(".png"):
                np.testing.assert_array_equal(
                    cv2.imread(os.path.join(a, name)),
                    cv2.imread(os.path.join(b, name)))
            else:
                assert open(os.path.join(a, name), "rb").read() == \
                    open(os.path.join(b, name), "rb").read(), (sub, name)


# --------------------------------------------------------- save and evaluate
def _results_from_labels(tree, ids, seed):
    """{image id: {class id: rows}} from the GT labels, rows [alpha, bbox,
    dim, loc, ry, score] with noise; the first object of the first frame
    is missing and the first of the second frame has the wrong class."""
    rng = np.random.RandomState(seed)
    classes = {"Car": 1, "Van": 2, "Truck": 3}
    results, results_raw = {}, {}
    for n, img_id in enumerate(ids):
        per = {c: [] for c in classes.values()}
        raw = {c: [] for c in classes.values()}
        path = os.path.join(tree, "kitti", "training", "label_2",
                            f"{img_id:06d}.txt")
        for j, ln in enumerate(open(path)):
            f = ln.split()
            row = np.array([float(v) for v in f[3:15]] + [0.9], np.float64)
            row[1:5] += rng.uniform(-3, 3, 4)
            row[10] += rng.uniform(-0.8, 0.8)
            row[11] += rng.uniform(-0.2, 0.2)
            row[12] = rng.uniform(0.3, 1.0)
            r = row.copy()
            r[10] += rng.uniform(-1.5, 1.5)
            cls = classes[f[0]]
            if n == 0 and j == 0:
                continue
            if n == 1 and j == 0:
                cls = cls % 3 + 1
            per[cls].append(row)
            raw[cls].append(r)
        results[img_id] = {c: np.array(v, np.float64).reshape(-1, 13)
                           for c, v in per.items()}
        results_raw[img_id] = {c: np.array(v, np.float64).reshape(-1, 13)
                               for c, v in raw.items()}
    return results, results_raw


@pytest.fixture(scope="module")
def eval_base(tree, tmp_path_factory):
    """A KITTI dir with the tree's labels and val.txt = the 16 train ids
    (the protocol's val = train)."""
    base = tmp_path_factory.mktemp("eval_base")
    shutil.copytree(os.path.join(tree, "kitti", "training", "label_2"),
                    base / "training" / "label_2")
    (base / "ImageSets_3dop").mkdir()
    (base / "ImageSets_3dop" / "val.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(N_SCENES)))
    return str(base)


@pytest.mark.parametrize("inject", [None, "ry_flip", "depth_sign",
                                    "class_shift"])
def test_save_and_eval_equals_jax(eval_base, tree, tmp_path, inject):
    overfit = importlib.import_module("test_overfit_ap")
    results, results_raw = _results_from_labels(tree, range(N_SCENES), 3)
    want_aps, want = overfit._save_and_eval(
        acc.copy_results(results), acc.copy_results(results_raw),
        eval_base, str(tmp_path / "jax"), inject=inject)
    got_aps, got = acc.save_and_eval(
        acc.copy_results(results), acc.copy_results(results_raw),
        eval_base, str(tmp_path / "port"), inject=inject)
    assert "car_detection" in want_aps
    assert got_aps == want_aps
    assert len(got) == len(want) >= 24
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], float) and math.isfinite(b[k]):
                assert abs(a[k] - b[k]) <= 1e-12, (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)
    # the missing object and the wrong class show in the errors
    assert sum(e["iou"] == 0 for e in got) == 1
    n_wrong = sum(not e["cls_ok"] for e in got)
    assert n_wrong == (len(got) if inject == "class_shift" else 2)


# ---------------------------------------------------------- summary, floors
def _canned(n_objects=30, **changes):
    """A protocol output {variant: (aps, errors)} that passes every floor of
    both protocols; `changes` overrides parts of it."""
    types = ["Car", "Van", "Truck"]
    errors = [{"iou": 0.8 + 0.005 * (i % 7), "z": 0.3 + 0.01 * i,
               "ry": 0.05 + 0.002 * i, "z_cv": 0.2 + 0.01 * i,
               "gt_type": types[i % 3], "cls_ok": True}
              for i in range(n_objects)]
    clean = {"car_detection": (45.4, 45.4, 45.4),
             "car_detection_ground": (12.5, 12.0, 12.0),
             "car_detection_3d": (12.5, 12.0, 12.0)}
    zero = {"car_detection": clean["car_detection"],
            "car_detection_ground": (0.0, 0.0, 0.0),
            "car_detection_3d": (0.0, 0.0, 0.0)}
    shifted = [dict(e, cls_ok=False) for e in errors]
    out = {"clean": (clean, errors), "ry_flip": (dict(zero), errors),
           "depth_sign": (dict(zero), errors),
           "class_shift": ({"car_detection": (0.0, 0.0, 0.0)}, shifted)}
    for key, fn in changes.items():
        fn(out)
    return out


def _set_err(key, value, index=0, variant="clean"):
    def fn(out):
        out[variant][1][index] = dict(out[variant][1][index], **{key: value})
    return fn


def _set_ap(metric, value, variant="clean"):
    def fn(out):
        out[variant][0][metric] = value
    return fn


FLOOR_CASES = {
    "pass": {},
    "ap3d_low": {"a": _set_ap("car_detection_3d", (12.0, 4.9, 5.0))},
    "apbev_low": {"a": _set_ap("car_detection_ground", (4.0, 6.0, 6.0))},
    # the 2D AP is the same in the clean run and the ry / depth variants
    "ap2d_low": {v: _set_ap("car_detection", (8.9, 45.0, 45.0), v)
                 for v in ("clean", "ry_flip", "depth_sign")},
    "undetected": {"a": _set_err("iou", 0.0, 4)},
    "iou_low": {"a": _set_err("iou", 0.55, 2)},
    "wrong_class": {"a": _set_err("cls_ok", False, 1)},
    "z_cv_worst": {"a": _set_err("z_cv", 2.5, 3)},
    "z_worst": {"a": _set_err("z", 5.5, 3)},
    "ry_worst": {"a": _set_err("ry", 0.45, 5)},
    "ry_flip_not_zero": {"a": _set_ap("car_detection_3d", (1.0, 0.0, 0.0),
                                      "ry_flip")},
    "depth_sign_2d_moved": {"a": _set_ap("car_detection", (40.0, 45.4, 45.4),
                                         "depth_sign")},
    "class_shift_ap": {"a": _set_ap("car_detection", (9.1, 0.0, 0.0),
                                    "class_shift")},
    "class_shift_cls_ok": {"a": _set_err("cls_ok", True, 0, "class_shift")},
}


def _jax_test_passes(test, out, monkeypatch, tmp_path):
    """Run a JAX acceptance test function on a canned protocol output."""
    overfit = importlib.import_module("test_overfit_ap")
    monkeypatch.setattr(overfit, "run_overfit_variants",
                        lambda *a, **k: copy.deepcopy(out))
    monkeypatch.setattr(overfit, "run_overfit_ap",
                        lambda *a, **k: copy.deepcopy(out["clean"]))
    try:
        getattr(overfit, test)(tmp_path)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("case", sorted(FLOOR_CASES))
def test_floors_agree_with_the_jax_tests(case, monkeypatch, tmp_path):
    """floors_16 / floors_2 fail exactly where the JAX tests'
    assertions fail, on the same protocol output."""
    out = _canned(**FLOOR_CASES[case])
    for n, test in ((16, "test_fixture_acceptance_16scene"),
                    (2, "test_fixture_overfit_ap")):
        failed = acc.FLOORS[n](copy.deepcopy(out))
        assert (not failed) == _jax_test_passes(test, out, monkeypatch,
                                                tmp_path), (n, failed)
    if case == "pass":
        assert not acc.floors_16(out) and not acc.floors_2(out)
    # the convention part of the floors: what a convention error breaks
    assert bool(acc.convention_failures(out)) == (case in CONVENTION_CASES)


CONVENTION_CASES = {"undetected", "wrong_class", "ry_flip_not_zero",
                    "depth_sign_2d_moved", "class_shift_ap",
                    "class_shift_cls_ok"}


def test_summary_lines_equal_the_jax_tool(monkeypatch, tmp_path, capsys):
    """The variant lines and summary.json of both tools on one canned
    output (an undetected object included: inf written as null)."""
    out = _canned(a=_set_err("iou", 0.0, 4), b=_set_err("z", np.inf, 4),
                  c=_set_err("ry", np.inf, 4))
    overfit = importlib.import_module("test_overfit_ap")
    monkeypatch.setattr(overfit, "run_overfit_variants",
                        lambda *a, **k: copy.deepcopy(out))
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    jtool = importlib.import_module("acceptance_16")
    monkeypatch.setattr(sys, "argv", ["acceptance_16.py", "--out",
                                      str(tmp_path / "jax")])
    jtool.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"run"')]

    def fake(tmp, _capture=None, **kw):
        _capture.update(timing={"train_s": 1.0}, launches={})
        return copy.deepcopy(out)

    monkeypatch.setattr(acc, "run_overfit_variants", fake)
    assert acc.main(["--out", str(tmp_path / "port"), "--check", "16"]) == 1
    printed = capsys.readouterr().out
    got = [ln for ln in printed.splitlines() if ln.startswith('{"run"')]
    assert got == want and len(got) == 4
    assert "FLOOR FAILED (16-scene protocol): every GT object detected" \
        in printed
    assert (tmp_path / "port" / "summary.json").read_text() == \
        (tmp_path / "jax" / "summary.json").read_text()
    assert json.loads((tmp_path / "port" / "summary.json").read_text())[
        "clean"]["z_max"] is None


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tool once on the CPU: 2 scenes, 2 epochs, 64x192, f32; (out
    dir, return code, printed lines)."""
    out = tmp_path_factory.mktemp("tiny") / "run"
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = acc.main(["--device", "cpu", "--scenes", "2", "--batch", "2",
                       "--epochs", "2", "--input_h", "64", "--input_w",
                       "192", "--out", str(out)])
    return out, rc, buf.getvalue()


def test_tool_end_to_end_on_cpu(tiny_run):
    """2 scenes, 2 epochs, 64x192, f32 on the CPU: four variant lines,
    summary.json and the checkpoint the detection read."""
    out, rc, printed = tiny_run
    assert rc == 0
    lines = [json.loads(ln) for ln in printed.splitlines()
             if ln.startswith('{"run"')]
    assert [ln["run"] for ln in lines] == ["clean", "ry_flip", "depth_sign",
                                           "class_shift"]
    assert all(ln["n_objects"] == 2 for ln in lines)
    summary = json.loads((out / "summary.json").read_text())
    assert sorted(summary) == sorted(ln["run"] for ln in lines)
    timing = json.loads(next(ln for ln in printed.splitlines()
                             if ln.startswith("timing: "))[8:])
    assert timing["steps"] == 2 and timing["detect_frames"] == 4
    assert (out / "exp" / "model_last.npz").exists()
    assert sorted(os.listdir(out / "exp" / "results")) == \
        ["000000.txt", "000001.txt"]
    assert sorted(os.listdir(out / "data" / "kitti" / "training" /
                             "label_2")) == ["000000.txt", "000001.txt"]


def test_depth_fit_leaves_the_model_as_loaded(tiny_run):
    """`depth_fit` on the tiny run's checkpoint: one signed error per GT
    object in each BatchNorm mode, finite, and the same on a second call
    (the training-mode pass does not move the running statistics the
    next pass reads)."""
    from side_tpu_torch.ops import deform_conv as tdc
    out = tiny_run[0]
    cfg = acc.protocol_config(str(out), str(out), (64, 192), 2,
                              epochs=2)
    scenes = fixture_scenes(2, 2, seed=0)[:2]
    with tdc.dcn_mode("windowed", 1):
        fits = [rate.depth_fit(cfg, scenes, str(out / "exp" /
                                                 "model_last.npz"), "cpu")
                for _ in range(2)]
    assert sorted(fits[0]) == ["eval_bn", "train_bn"]
    for key, errs in fits[0].items():
        assert len(errs) == 2 and all(math.isfinite(e) for e in errs), key
    assert fits[0] == fits[1]
    assert fits[0]["train_bn"] != fits[0]["eval_bn"]


def test_rate_tool_lines(tiny_run, monkeypatch, capsys):
    """acceptance_rate's lines: one per (mode, dtype, rep) with the floors
    the protocol's run failed and the depth fit of its checkpoint, then
    the tally."""
    ckpt = str(tiny_run[0] / "exp" / "model_last.npz")
    calls = []

    def fake(tmp, _capture=None, **kw):
        calls.append(kw)
        _capture.update(checkpoint=ckpt)
        if kw["compute_dtype"] == "float32":
            return _canned(n_objects=2)
        return _canned(n_objects=2, a=_set_err("z_cv", 0.9, 0),
                       b=_set_err("z_cv", 0.8, 1))

    monkeypatch.setattr(acc, "run_overfit_variants", fake)
    assert rate.main(["--device", "cpu", "--reps", "1", "--dcn",
                      "windowed,exact", "--dtypes", "float32,bfloat16",
                      "--input_h", "64", "--input_w",
                      "192", "--out", str(tiny_run[0] / "rate")]) == 0
    printed = capsys.readouterr().out.splitlines()
    lines = [json.loads(ln) for ln in printed if ln.startswith('{"mode"')]
    assert [(ln["mode"], ln["dtype"]) for ln in lines] == [
        ("windowed", "float32"), ("windowed", "bfloat16"),
        ("exact", "float32"), ("exact", "bfloat16")]
    assert [c["radius"] for c in calls] == [1, 1, -1, -1]
    assert all(c["epochs"] == 160 and c["n_scenes"] == 2 and
               c["batch_size"] == 2 and c["input_hw"] == (64, 192)
               for c in calls)
    assert [ln["floors_failed"] for ln in lines] == [
        [], ["z_cv median <= 0.5 m"], [], ["z_cv median <= 0.5 m"]]
    assert lines[1]["z_cv"] == [0.9, 0.8]
    assert all(set(ln["depth_fit"]) == {"train_bn", "eval_bn"}
               for ln in lines)
    assert all(ln["seed"] == 0 and ln["rep"] == 0 for ln in lines)
    assert [c["seed"] for c in calls] == [0, 0, 0, 0]
    met = {"runs": 1, "met_every_floor": 1, "misses": {}}
    missed = {"runs": 1, "met_every_floor": 0,
              "misses": {"z_cv median <= 0.5 m": 1}}
    assert json.loads(printed[-1][len("tally: "):]) == {
        "scenes": 2, "runs": 4, "met_every_floor": 2,
        "by": {"windowed/float32": met, "windowed/bfloat16": missed,
               "exact/float32": met, "exact/bfloat16": missed}}


@pytest.mark.parametrize("text,seeds", [
    ("0", [0]), ("0-15", list(range(16))), ("0,3,5-7", [0, 3, 5, 6, 7]),
    ("4-4,2", [4, 2])])
def test_parse_seeds(text, seeds):
    assert rate.parse_seeds(text) == seeds


def test_rate_tool_runs_each_seed(monkeypatch, tmp_path, capsys):
    """`--seeds` runs the protocol once per seed and `--reps` times each,
    every line carrying its seed; the tally counts the misses of each
    floor by name."""
    calls = []

    def fake(tmp, _capture=None, **kw):
        calls.append((kw["seed"], tmp))
        _capture.update(checkpoint="unused")
        if kw["seed"] == 5:
            return _canned(n_objects=2, a=_set_err("ry", 0.5, 1))
        return _canned(n_objects=2)

    monkeypatch.setattr(acc, "run_overfit_variants", fake)
    monkeypatch.setattr(rate, "depth_fit",
                        lambda *a: {"train_bn": [0.1], "eval_bn": [0.2]})
    assert rate.main(["--device", "cpu", "--seeds", "0-1,5", "--reps", "2",
                      "--dcn", "windowed", "--dtypes", "float32",
                      "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out.splitlines()
    lines = [json.loads(ln) for ln in printed if ln.startswith('{"mode"')]
    assert [(ln["seed"], ln["rep"]) for ln in lines] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (5, 0), (5, 1)]
    assert [c[0] for c in calls] == [0, 0, 1, 1, 5, 5]
    assert len({c[1] for c in calls}) == 6
    assert json.loads(printed[-1][len("tally: "):]) == {
        "scenes": 2, "runs": 6, "met_every_floor": 4,
        "by": {"windowed/float32": {
            "runs": 6, "met_every_floor": 4,
            "misses": {"ry worst <= 0.4 rad": 2}}}}


def _lines(met, missed, floor="z_cv median <= 0.5 m"):
    return ([{"floors_failed": []}] * met +
            [{"floors_failed": [floor]}] * missed)


@pytest.mark.parametrize("jax_runs,port_runs,p_low,only_port", [
    # (a): at 6 of 6 for JAX the port needs 9 of 16
    (_lines(6, 0), _lines(8, 8, "ry worst <= 0.4 rad"), True,
     ["ry worst <= 0.4 rad"]),
    (_lines(6, 0), _lines(9, 7), False, []),
    # (b) alone: one floor in 8 of 16 port runs and in none of JAX's
    (_lines(3, 3, "ry worst <= 0.4 rad"), _lines(8, 8), False,
     ["z_cv median <= 0.5 m"]),
    (_lines(3, 3), _lines(8, 8), False, []),
])
def test_decision_rule(jax_runs, port_runs, p_low, only_port):
    """PERF.md's decision rule: a one-sided Fisher exact test on the
    shares, and a floor the port misses in half its runs and JAX never."""
    import torch_acceptance_share as share
    got = share.decide(jax_runs, port_runs)
    assert (got["p"] < 0.05) is p_low
    assert got["floors_only_port"] == only_port
    assert got["fault"] is (p_low or bool(only_port))


def test_share_cli_runs_the_protocol(monkeypatch, capsys):
    """tests/torch_acceptance_share.py runs each side at the protocol's own
    settings (no knob changes the epochs or the size) and writes under
    exp/share, relative to where it is run, one directory per side and
    seed."""
    import torch_acceptance_share as share
    jax_calls, port_argv = [], []

    def fake_jax(tmp, **kw):
        jax_calls.append((tmp, kw))
        return _canned(n_objects=2)

    monkeypatch.setattr(share, "run_jax_protocol", fake_jax)
    monkeypatch.setattr(share.rate, "main", lambda argv: port_argv.append(
        argv) or 0)
    assert share.main(["--seeds", "3-4"]) == 0
    assert jax_calls == [
        (os.path.join("exp", "share", "jax", str(s)),
         dict(seed=s, verbose=False)) for s in (3, 4)]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(ln["side"], ln["mode"], ln["dtype"], ln["seed"])
            for ln in lines] == [("jax", "windowed", "float32", s)
                                 for s in (3, 4)]
    assert share.main(["--side", "port", "--device", "cpu",
                       "--seeds", "3-4"]) == 0
    assert port_argv == [[
        "--scenes", "2", "--seeds", "3-4", "--dcn", "windowed",
        "--dtypes", "float32", "--out", os.path.join("exp", "share", "port"),
        "--device", "cpu"]]
    for knob in ("--epochs", "--input_h", "--input_w"):
        with pytest.raises(SystemExit):
            share.main([knob, "2"])


def test_judge_counts_each_seeds_draws(tmp_path, capsys):
    """`--judge` applies the rule to the windowed float32 lines of the two
    logs and counts, per seed, the port's runs that met every floor."""
    import torch_acceptance_share as share

    def log(name, lines):
        path = tmp_path / name
        path.write_text("".join(json.dumps(ln) + "\n" for ln in lines)
                        + "tally: {}\n")
        return str(path)

    def run(seed, failed=(), dtype="float32", **kw):
        return dict(kw, mode="windowed", dtype=dtype, seed=seed,
                    floors_failed=list(failed))

    miss = ["z_cv median <= 0.5 m"]
    jax_log = log("jax.log", [run(0, side="jax"), run(1, miss, side="jax"),
                              run(2, side="jax", dtype="bfloat16")])
    port_log = log("port.log", [run(1), run(0, miss), run(0), run(1, miss),
                                run(1), run(0, dtype="bfloat16")])
    assert share.main(["--judge", jax_log, port_log]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["jax"] == [1, 2] and got["port"] == [3, 5]
    assert got["port_by_seed"] == {"0": [1, 2], "1": [2, 3]}
    assert got["fault"] is False


class _Stop(Exception):
    """Raised by the stand-in Trainer once it has read its first epoch."""


def _tf32():
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _first_epoch(monkeypatch, module, run):
    """`run()` with `module.Trainer` replaced by one that records its
    arguments, the first epoch's batches and the TF32 flags, then stops."""
    seen = {}

    class FirstEpoch:
        def __init__(self, cfg, model, *args, **kw):
            seen.update(cfg=cfg, model=model, args=args)

        def train(self, epoch, loader):
            seen["batches"] = [copy.deepcopy(b) for b in loader]
            seen["tf32"] = _tf32()
            raise _Stop

    monkeypatch.setattr(module, "Trainer", FirstEpoch)
    with pytest.raises(_Stop):
        run()
    return seen


def _samples(batches):
    """Each sample of `batches` as bytes, in batch order."""
    return [b"".join(np.ascontiguousarray(b[k][i]).tobytes()
                     for k in sorted(b))
            for b in batches for i in range(len(next(iter(b.values()))))]


def test_seed_draws_the_weights_and_the_order(monkeypatch, tmp_path):
    """`run_overfit_ap(seed=)`: at seed 0 the model and the first epoch's
    batches are create_model(cfg, seed=0)'s and Loader(seed=0)'s, as
    before the seed existed; at seed 1 both change and the scenes do
    not."""
    import side_tpu_torch.runtime.trainer as ttrainer
    from side_tpu_torch.models.factory import create_model
    hw = (64, 192)
    caps = {0: {}, 1: {}}
    runs = {seed: _first_epoch(monkeypatch, ttrainer, lambda seed=seed:
                               acc.run_overfit_ap(
                                   str(tmp_path / f"s{seed}"), input_hw=hw,
                                   device="cpu", seed=seed,
                                   _capture=caps[seed]))
            for seed in (0, 1)}
    cfg = acc.protocol_config(str(tmp_path), str(tmp_path), hw, 2)
    want_model = create_model(cfg, seed=0).state_dict()
    want_batches = [copy.deepcopy(b) for b in Loader(
        FixtureKitti(cfg, fixture_scenes(2, 2, seed=0)[:2]), 2,
        shuffle=True, num_workers=2, drop_last=True, seed=0)]
    states = {s: r["model"].state_dict() for s, r in runs.items()}
    assert sorted(states[0]) == sorted(want_model)
    assert all(torch_equal(states[0][k], want_model[k]) for k in want_model)
    assert not all(torch_equal(states[1][k], want_model[k])
                   for k in want_model)
    assert _samples(runs[0]["batches"]) == _samples(want_batches)
    assert _samples(runs[1]["batches"]) != _samples(want_batches)
    assert sorted(_samples(runs[1]["batches"])) == \
        sorted(_samples(want_batches))
    assert caps[0]["fixture_digest"] == caps[1]["fixture_digest"]
    assert caps[0]["initial_digest"] != caps[1]["initial_digest"]


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def test_jax_runner_copy_is_the_protocol(monkeypatch, tmp_path):
    """tests/torch_acceptance_share.py's copy of the JAX protocol at seed
    0 builds test_overfit_ap.run_overfit_ap's Config (but for its paths),
    initial variables and first-epoch batches, read without training."""
    from dataclasses import replace
    import jax
    import side_tpu.runtime.trainer as jtrainer
    import test_overfit_ap as jtest
    import torch_acceptance_share as share
    hw = (64, 192)
    want = _first_epoch(monkeypatch, jtrainer, lambda: jtest.run_overfit_ap(
        str(tmp_path / "test"), input_hw=hw))
    got = _first_epoch(monkeypatch, jtrainer, lambda: share.run_jax_protocol(
        str(tmp_path / "share"), seed=0, input_hw=hw))
    assert replace(got["cfg"], data_dir="", exp_dir="") == \
        replace(want["cfg"], data_dir="", exp_dir="")
    assert got["cfg"].data_dir != want["cfg"].data_dir
    (gv,), (wv,) = got["args"], want["args"]
    assert jax.tree.structure(gv) == jax.tree.structure(wv)
    for a, b in zip(jax.tree.leaves(gv), jax.tree.leaves(wv)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _samples(got["batches"]) == _samples(want["batches"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_runs_without_tf32(dtype, tiny_run, monkeypatch, tmp_path):
    """An f32 run trains and detects with TF32 off in matmuls and cuDNN
    and gives the flags back as they were; a bf16 run leaves them
    alone."""
    import torch
    import side_tpu_torch.runtime.trainer as ttrainer
    import side_tpu_torch.val as tval
    before = (True, False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before[0])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[1])
    during = (False, False) if dtype == "float32" else before
    kw = dict(input_hw=(64, 192), device="cpu", compute_dtype=dtype)
    train = _first_epoch(monkeypatch, ttrainer, lambda: acc.run_overfit_ap(
        str(tmp_path / "train"), **kw))
    assert train["tf32"] == during
    assert _tf32() == before
    seen = []

    def run_pass(*args, **kwargs):
        seen.append(_tf32())
        raise _Stop

    monkeypatch.setattr(tval, "run_pass", run_pass)
    with pytest.raises(_Stop):
        acc.run_overfit_ap(str(tmp_path / "detect"), ckpt=str(
            tiny_run[0] / "exp" / "model_last.npz"), **kw)
    assert seen == [during]
    assert _tf32() == before


# ----------------------------------------------------------------- slow
@pytest.fixture(scope="module")
def two_scene_run(tmp_path_factory):
    """The 2-scene protocol (batch 2, 160 epochs, 128x384, f32) on the
    CPU: (protocol output, checkpoint path)."""
    tmp = tmp_path_factory.mktemp("two_scene")
    out = acc.run_overfit_variants(str(tmp), epochs=160, n_scenes=2,
                                   batch_size=2, device="cpu")
    return out, str(tmp / "exp" / "model_last.npz")


@pytest.mark.slow
def test_trained_checkpoint_reads_in_jax(two_scene_run):
    """The 2-scene protocol's trained checkpoint read by the JAX package's
    Detector gives the port's rows on a fixture frame (checkpoint
    interchange on trained weights)."""
    import jax
    from side_tpu.ops.deform_conv import dcn_mode as jdcn_mode
    from side_tpu.runtime.checkpoint import load_checkpoint
    from side_tpu.runtime.detector import Detector as JDetector
    from side_tpu_torch.config import Config
    from side_tpu_torch.ops import deform_conv as tdc
    from side_tpu_torch.runtime.detector import Detector

    ckpt = two_scene_run[1]
    loaded = load_checkpoint(ckpt)
    kw = dict(PROTOCOL, batch_size=2)
    _, (left, right), calib = fixture_frames(fixture_scenes(2, 2, 0)[:1])[0]
    with jdcn_mode("windowed"):
        jdet = JDetector(JConfig(**kw), variables=jax.tree.map(
            jax.numpy.asarray, {"params": loaded["params"],
                                "batch_stats": loaded["batch_stats"]}))
        want = jdet.run((left, right), calib=calib)["results"]
    with tdc.dcn_mode("windowed", 1):
        got = Detector(Config(load_model=ckpt, **kw), device="cpu").run(
            (left, right), calib=calib)["results"]
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= 1
    for cls in want:
        a, b = np.asarray(got[cls]), np.asarray(want[cls])
        assert a.shape == b.shape, cls
        np.testing.assert_allclose(a, b, atol=1e-3 * max(
            1.0, float(np.abs(b).max(initial=0.0))), err_msg=str(cls))


@pytest.mark.slow
def test_two_scene_protocol_meets_its_floors(two_scene_run):
    """The 2-scene protocol on the CPU meets the floors of
    test_fixture_overfit_ap."""
    out = two_scene_run[0]
    assert acc.floors_2(out) == [], (acc.summarize(out)["clean"],
                                     out["clean"][1])
