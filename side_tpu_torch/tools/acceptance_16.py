"""The discriminative acceptance protocol on the port: train on the fixed
synthetic fixture, detect on the same scenes, score with the C++ evaluator
(port of tools/acceptance_16.py and of the protocol in
tests/test_overfit_ap.py).

    python -m side_tpu_torch.tools.acceptance_16 --check 16
    python -m side_tpu_torch.tools.acceptance_16 --scenes 2 --batch 2 \\
        --epochs 160 --check 2

  1. train on `--scenes` scenes of `data/synthetic.fixture_scenes` (the
     scenes `build_fixture` writes, held in memory: no OpenCV), mixing easy
     / occluded / truncated recipes and Car / Van / Truck; val = train;
  2. detect on the same scenes from the checkpoint the run wrote
     (`model_last.npz`, loaded through `cfg.load_model`): one
     `val.run_pass` with the dense alignment and one without (`z_cv`, the
     cost volume's own depth), write KITTI txt files, run the evaluator;
  3. re-score the same predictions with an injected convention bug
     (`ry_flip`: +pi/2 on every rotation; `depth_sign`: negated depth;
     `class_shift`: class buckets rotated by one), which must take the
     floors to 0.

Prints one JSON line per variant with the JAX tool's keys, a `timing` line,
and writes `summary.json` (non-finite values as null).  `--check 16` (batch
4, 240 epochs: the defaults) or `--check 2` (batch 2, 160 epochs) asserts
that protocol's floors, the JAX tests' own, and exits 1 if one fails.
`--compute_dtype` (default float32, the JAX protocol's), `--device cpu`,
`--input_h/--input_w` (default 128x384, the protocol's size) and
`--deterministic` (train and detect under `dcn_cuda.deterministic_mode`:
the same trained weights, bit for bit, every run on one card and software
stack; `weights_digest` names them) beside the JAX tool's flags.  Runs on the GPU unless `--device cpu` is given; writes
under `--out` (default exp/acc16).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import time
from dataclasses import replace

import numpy as np

from ..config import CLASS_NAMES, Config
from ..ops import deform_conv as dc

ALL_CLASSES = ("Car", "Van", "Truck")
SPLIT = "3dop"
# (Cin, H, W, Cout) of the 16 DeformBlocks at the protocol's 128x384 input,
# trained at 4 stereo pairs (B = 8 images): each the full-size training
# shape with H and W divided by 3, most a tile or a few and ragged in both
# directions
PROTOCOL_SHAPES = [(512, 4, 12, 256), (256, 8, 24, 256), (256, 8, 24, 128),
                   (256, 8, 24, 64), (128, 16, 48, 128), (128, 16, 48, 64),
                   (64, 32, 96, 64)]


def protocol_config(data_dir, save_dir, input_hw=(128, 384), batch_size=2,
                    lr=1e-3, epochs=160, compute_dtype="float32") -> Config:
    """tests/test_overfit_ap.py:81-87: no augmentation, one lr, K = 16."""
    return Config(data_dir=data_dir, exp_dir=save_dir,
                  input_h=input_hw[0], input_w=input_hw[1],
                  batch_size=batch_size, lr=lr, lr_step=(10 ** 9,),
                  num_epochs=epochs, max_objs=16, K=16,
                  aug_ddd=0.0, no_color_aug=True, flip_train=False,
                  compute_dtype=compute_dtype, num_devices=1, uncert=False,
                  peak_thresh=0.25)


def run_overfit_ap(tmp, epochs=160, lr=1e-3, input_hw=(128, 384),
                   run_align=True, verbose=False, n_scenes=2,
                   batch_size=2, inject=None, ckpt=None,
                   compute_dtype="float32", device=None, radius=1,
                   deterministic=False, keep_dcn_mode=False, init=None,
                   _capture=None):
    """Train on the fixture and close the full accuracy loop; returns
    (aps, per-object errors).

    n_scenes=2 is the 2-scene overfit protocol, n_scenes=16 the
    discriminative one.  `inject` corrupts the predictions before they are
    saved (see `save_and_eval`).  `ckpt`: a model_last.npz of an earlier
    run of the same protocol; training is skipped.  `_capture` receives the
    results, the paths, wall times and the DCN kernels' launches during
    training and during detection.  `radius`: the DCN's offset bound, 1 as
    in the JAX protocol; -1 runs the exact (unbounded) DCN.
    `deterministic`: train and detect under `dcn_cuda.deterministic_mode`.
    `keep_dcn_mode`: detect at `radius` whatever the checkpoint's
    `meta::dcn_radius` says (by default the Detector switches to it).
    `init`: a checkpoint the Trainer loads (weights only, a fresh Adam)
    before it trains."""
    from ..data.loader import Loader
    from ..data.synthetic import FixtureKitti, fixture_frames, fixture_scenes
    from ..models.factory import create_model
    from ..ops.dcn_cuda import (deterministic_mode, launch_counts,
                                launches_since)
    from ..runtime.detector import Detector
    from ..runtime.trainer import Trainer
    from .. import val

    data_dir = os.path.join(tmp, "data")
    save_dir = os.path.join(tmp, "exp")
    base = os.path.join(data_dir, "kitti")
    os.makedirs(save_dir, exist_ok=True)
    # overfit protocol: val == train
    scenes = fixture_scenes(n_train=n_scenes, n_val=2, seed=0)[:n_scenes]
    frames = fixture_frames(scenes, os.path.join(base, "training", "label_2"))
    os.makedirs(os.path.join(base, f"ImageSets_{SPLIT}"), exist_ok=True)
    with open(os.path.join(base, f"ImageSets_{SPLIT}", "val.txt"), "w") as f:
        f.write("\n".join(sc["name"] for sc in scenes) + "\n")
    cfg = protocol_config(data_dir, save_dir, input_hw, batch_size, lr,
                          epochs, compute_dtype)
    capture = {} if _capture is None else _capture
    timing = capture.setdefault("timing", {})
    launches = capture.setdefault("launches", {})

    with (dc.dcn_mode("windowed", radius) if radius >= 0
          else dc.dcn_mode("exact")), \
            (deterministic_mode() if deterministic
             else contextlib.nullcontext()):
        if ckpt:
            path = ckpt
        else:
            loader = Loader(FixtureKitti(cfg, scenes), cfg.batch_size,
                            shuffle=True, num_workers=2, drop_last=True,
                            seed=0)
            trainer = Trainer(cfg, create_model(cfg, seed=0),
                              steps_per_epoch=len(loader), device=device)
            if init:
                trainer.load(init)
            before = launch_counts()
            t0 = time.perf_counter()
            for epoch in range(1, epochs + 1):
                stats = trainer.train(epoch, loader)
                if verbose and (epoch % 10 == 0 or epoch == 1):
                    print(f"[overfit] epoch {epoch}: " +
                          " ".join(f"{k}={v:.3f}" for k, v in stats.items()),
                          flush=True)
            train_s = time.perf_counter() - t0
            launches["train"] = launches_since(before)
            assert np.isfinite(stats["loss"]), stats
            timing.update(train_s=train_s, epochs=epochs,
                          steps=trainer.step,
                          s_per_epoch=train_s / epochs,
                          ms_per_step=train_s / trainer.step * 1e3,
                          final_loss={k: float(v) for k, v in stats.items()})
            path = os.path.join(save_dir, "model_last.npz")
            trainer.save(path, epochs)
            timing["weights_digest"] = weights_digest(path)
            del trainer

        # -------- inference on the (identical) val split, full tail -------
        detector = Detector(replace(cfg, load_model=path), device=device,
                            keep_dcn_mode=keep_dcn_mode)
        before = launch_counts()
        t0 = time.perf_counter()
        results, _, _ = val.run_pass(cfg, frames, detector, n=len(frames),
                                     eval_batch=1, no_align=not run_align)
        # run_align=False: the depth is the raw cost-volume z
        results_raw = (val.run_pass(cfg, frames, detector, n=len(frames),
                                    eval_batch=1, no_align=True)[0]
                       if run_align else results)
        timing["detect_s"] = time.perf_counter() - t0
        timing["detect_frames"] = len(frames) * (2 if run_align else 1)
        launches["detect"] = launches_since(before)
    if verbose and run_align:
        for img_id in results:
            for cls in results[img_id]:
                for ra, rb in zip(np.asarray(results[img_id][cls]),
                                  np.asarray(results_raw[img_id][cls])):
                    print(f"[overfit] img {img_id} cls {cls}: "
                          f"z_cv={rb[10]:.2f} z_aligned={ra[10]:.2f} "
                          f"ry={ra[11]:+.2f}", flush=True)
    capture.update(results=results, results_raw=results_raw, base=base,
                   save_dir=save_dir, checkpoint=path)
    return save_and_eval(results, results_raw, base, save_dir,
                         inject=inject, verbose=verbose)


def weights_digest(path) -> str:
    """sha256 over a checkpoint's arrays (names, dtypes, shapes and bytes,
    in name order): equal for the same weights, whatever the file's zip
    metadata."""
    h = hashlib.sha256()
    with np.load(path, allow_pickle=False) as z:
        for name in sorted(z.files):
            a = np.ascontiguousarray(z[name])
            h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def run_overfit_variants(tmp, variants=("clean", "ry_flip", "depth_sign",
                                        "class_shift"), **kw):
    """One train + one inference pass, evaluated once per variant (the
    corruptions apply to saved predictions, not to the model).  Returns
    {variant: (aps, errors)}; a `_capture` dict in `kw` gets what
    `run_overfit_ap` captures."""
    kw.pop("inject", None)
    verbose = kw.get("verbose", False)
    store = kw.pop("_capture", None)
    store = {} if store is None else store
    aps0, errors0 = run_overfit_ap(tmp, inject=None, _capture=store, **kw)
    out = {"clean": (aps0, errors0)}
    base = store["base"]
    for variant in variants:
        if variant == "clean":
            continue
        vdir = os.path.join(tmp, f"variant_{variant}")
        os.makedirs(vdir, exist_ok=True)
        out[variant] = save_and_eval(
            copy_results(store["results"]),
            copy_results(store["results_raw"]),
            base, vdir, inject=variant, verbose=verbose)
    return out


def copy_results(results):
    return {img: {cls: np.array(rows, np.float64, copy=True)
                  for cls, rows in per_cls.items()}
            for img, per_cls in results.items()}


def save_and_eval(results, results_raw, base, save_dir, inject=None,
                  verbose=False):
    """Corrupt (optionally), save KITTI txt files, run the evaluator against
    `base`/training/label_2 and match every GT object of
    `base`/ImageSets_3dop/val.txt to its best prediction by 2D IoU.
    Returns (aps, errors).

    inject: "ry_flip" (+pi/2 on every rotation_y), "depth_sign" (z
    negated), "class_shift" (class buckets rotated by one: the evaluator
    counts only detections of the evaluated class, so car AP, 2D included,
    must fall to 0)."""
    from ..postprocess.post_process import save_kitti_results
    from ..runtime.evaluator import run_eval

    if inject == "class_shift":
        for img in list(results.keys()):
            per_cls = results[img]
            keys = sorted(per_cls.keys())
            results[img] = {keys[(i + 1) % len(keys)]: per_cls[k]
                            for i, k in enumerate(keys)}
    elif inject:
        # row layout: [alpha, bbox x4, dim x3, loc x3, ry, score]
        for per_cls in results.values():
            for cls in per_cls:
                rows = np.array(per_cls[cls], np.float64, copy=True)
                if rows.size == 0:
                    continue
                if inject == "ry_flip":
                    rows[:, 11] += np.pi / 2
                elif inject == "depth_sign":
                    rows[:, 10] = -rows[:, 10]
                else:
                    raise ValueError(inject)
                per_cls[cls] = rows
    save_kitti_results(results, save_dir, CLASS_NAMES)
    raw_dir = os.path.join(save_dir, "raw")
    os.makedirs(raw_dir, exist_ok=True)
    save_kitti_results(results_raw, raw_dir, CLASS_NAMES)

    gt_dir = os.path.join(base, "training", "label_2")
    aps = run_eval(os.path.join(save_dir, "results"), gt_dir)

    # Per-object errors.  With a tiny fixture the evaluator's recall
    # sampling quantises AP to ~1 point per GT object, so the direct
    # per-object comparisons carry the discriminative assertions.
    errors = []
    with open(os.path.join(base, f"ImageSets_{SPLIT}", "val.txt")) as f:
        val_ids = [ln.strip() for ln in f if ln.strip()]

    def _best_match(g, rows):
        best, best_iou = None, 0.0
        for p in rows:
            iou = iou2d(g["bbox"], p["bbox"])
            if iou > best_iou:
                best, best_iou = p, iou
        return best, best_iou

    for vid in val_ids:
        gt_rows = read_kitti(os.path.join(gt_dir, f"{vid}.txt"), ALL_CLASSES)
        pr_rows = read_kitti(os.path.join(save_dir, "results", f"{vid}.txt"),
                             ALL_CLASSES)
        raw_rows = read_kitti(os.path.join(raw_dir, "results", f"{vid}.txt"),
                              ALL_CLASSES)
        for g in gt_rows:
            # match by 2D IoU over all classes, then record whether the
            # predicted class is right
            best, best_iou = _best_match(g, pr_rows)
            braw, _ = _best_match(g, raw_rows)
            z_cv = (abs(g["loc"][2] - braw["loc"][2])
                    if braw is not None else np.inf)
            if best is None:
                errors.append({"iou": 0.0, "z": np.inf, "ry": np.inf,
                               "z_cv": z_cv, "gt_type": g["type"],
                               "cls_ok": False})
                continue
            ry_err = abs((g["ry"] - best["ry"] + np.pi) % (2 * np.pi) - np.pi)
            errors.append({"iou": best_iou,
                           "z": abs(g["loc"][2] - best["loc"][2]),
                           "ry": ry_err, "z_cv": z_cv,
                           "gt_type": g["type"],
                           "cls_ok": best["type"] == g["type"]})
    if verbose:
        for e in errors:
            print(f"[overfit] obj: iou2d={e['iou']:.3f} "
                  f"z_err={e['z']:.2f}m z_cv_err={e['z_cv']:.2f}m "
                  f"ry_err={e['ry']:.3f}rad", flush=True)
    return aps, errors


def read_kitti(path, classes=("Car",)):
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as fh:
        for ln in fh:
            f = ln.split()
            if not f or f[0] not in classes:
                continue
            rows.append({"type": f[0],
                         "bbox": [float(v) for v in f[4:8]],
                         "dim": [float(v) for v in f[8:11]],
                         "loc": [float(v) for v in f[11:14]],
                         "ry": float(f[14])})
    return rows


def iou2d(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


# ------------------------------------------------------------------ floors
def floors_2(out) -> list:
    """tests/test_overfit_ap.py::test_fixture_overfit_ap: the failed floors
    of the 2-scene protocol's clean run (empty when all hold)."""
    aps, errors = out["clean"]
    if not errors:
        return ["no GT objects compared"]
    z = [e["z"] for e in errors]
    z_cv = [e["z_cv"] for e in errors]
    checks = [
        ("car 2D AP (easy) >= 9.0",
         aps.get("car_detection", (0.0,))[0] >= 9.0),
        ("every GT detected, 2D IoU >= 0.6",
         min(e["iou"] for e in errors) >= 0.6),
        ("z median <= 2.5 m", float(np.median(z)) <= 2.5),
        ("z worst <= 5.0 m", max(z) <= 5.0),
        ("ry worst <= 0.4 rad", max(e["ry"] for e in errors) <= 0.4),
        ("z_cv median <= 0.5 m", float(np.median(z_cv)) <= 0.5),
        ("z_cv worst <= 2.0 m", max(z_cv) <= 2.0),
    ]
    return [name for name, ok in checks if not ok]


def _checks_16(out) -> list:
    """(name, convention, ok) for every assertion of
    tests/test_overfit_ap.py::test_fixture_acceptance_16scene.
    `convention` marks what a convention error breaks whatever the
    training reached: every GT object detected with its class, and each
    injected bug taking its APs to exactly 0.0."""
    aps, errors = out["clean"]
    checks = [("car AP3D and APBEV reported", False,
               "car_detection_3d" in aps and "car_detection_ground" in aps)]
    for metric in ("car_detection_3d", "car_detection_ground"):
        checks.append((f"{metric} >= 5.0 at E/M/H", False,
                       min(aps.get(metric, (0.0,))) >= 5.0))
    checks += [
        (">= 24 GT objects compared", False, len(errors) >= 24),
        ("every GT object detected", True,
         bool(errors) and all(e["iou"] > 0 for e in errors)),
        ("2D IoU >= 0.6", False, bool(errors) and
         min(e["iou"] for e in errors) >= 0.6),
        ("z_cv median <= 1.0 m", False, bool(errors) and
         float(np.median([e["z_cv"] for e in errors])) <= 1.0),
        ("ry worst <= 0.5 rad", False, bool(errors) and
         max(e["ry"] for e in errors) <= 0.5),
    ]
    seen = {e["gt_type"] for e in errors}
    checks.append(("Car, Van and Truck present", False,
                   seen == set(ALL_CLASSES)))
    for cls in sorted(seen):
        ce = [e for e in errors if e["gt_type"] == cls]
        checks.append((f"{cls}: right class", True,
                       all(e["cls_ok"] for e in ce)))
        checks.append((f"{cls}: 2D IoU >= 0.6", False,
                       min(e["iou"] for e in ce) >= 0.6))
    for variant in ("ry_flip", "depth_sign"):
        v_aps, _ = out[variant]
        checks.append((f"{variant}: AP3D and APBEV exactly 0.0, 2D AP "
                       "equal to the clean run's", True,
                       max(v_aps.get("car_detection_3d", (0.0,))) == 0.0 and
                       max(v_aps.get("car_detection_ground", (0.0,))) == 0.0
                       and v_aps.get("car_detection")
                       == aps.get("car_detection")))
    s_aps, s_errors = out["class_shift"]
    checks.append(("class_shift: car 2D AP 0.0, no cls_ok", True,
                   max(s_aps.get("car_detection", (0.0,))) == 0.0 and
                   not any(e["cls_ok"] for e in s_errors)))
    return checks


def floors_16(out) -> list:
    """tests/test_overfit_ap.py::test_fixture_acceptance_16scene: the
    failed floors of the 16-scene protocol (empty when all hold)."""
    return [name for name, _, ok in _checks_16(out) if not ok]


def convention_failures(out) -> list:
    """The failed floors of the 16-scene protocol's kind that a convention
    error breaks (`_checks_16`); empty when all hold."""
    return [name for name, conv, ok in _checks_16(out) if conv and not ok]


FLOORS = {16: floors_16, 2: floors_2}


# --------------------------------------------------------------------- CLI
def summarize(out) -> dict:
    """{variant: summary} with tools/acceptance_16.py's keys."""
    runs = {}
    for tag, (aps, errors) in out.items():
        runs[tag] = {
            "run": tag,
            "aps": {k: list(v) for k, v in aps.items()},
            "n_objects": len(errors),
            "detected": sum(1 for e in errors if e["iou"] > 0),
            "iou_min": float(min((e["iou"] for e in errors), default=0.0)),
            "z_med": float(_med([e["z"] for e in errors])),
            "z_max": float(_fmax([e["z"] for e in errors])),
            "z_cv_med": float(_med([e["z_cv"] for e in errors])),
            "ry_max": float(_fmax([e["ry"] for e in errors])),
            "per_class": {
                cls: {"n": len(ce),
                      "detected": sum(1 for e in ce if e["iou"] > 0),
                      "cls_ok": sum(1 for e in ce if e.get("cls_ok"))}
                for cls in sorted({e.get("gt_type", "Car") for e in errors})
                for ce in [[e for e in errors
                            if e.get("gt_type", "Car") == cls]]},
        }
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m side_tpu_torch.tools.acceptance_16")
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("exp", "acc16"))
    ap.add_argument("--ckpt", default=None,
                    help="skip training, reuse a trained model_last.npz")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None,
                    help="cpu for the plain CPU path (default: the GPU)")
    ap.add_argument("--input_h", type=int, default=128)
    ap.add_argument("--input_w", type=int, default=384)
    ap.add_argument("--deterministic", action="store_true",
                    help="repeatable kernels and PyTorch algorithms")
    ap.add_argument("--check", type=int, choices=sorted(FLOORS),
                    help="assert the floors of the 16- or 2-scene protocol")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    capture = {}
    t0 = time.perf_counter()
    out = run_overfit_variants(
        args.out, epochs=args.epochs, n_scenes=args.scenes,
        batch_size=args.batch, ckpt=args.ckpt, verbose=args.verbose,
        input_hw=(args.input_h, args.input_w),
        compute_dtype=args.compute_dtype, device=args.device,
        deterministic=args.deterministic, _capture=capture)
    runs = summarize(out)
    for summary in runs.values():
        print(json.dumps(summary), flush=True)
    timing = dict(capture["timing"], total_s=time.perf_counter() - t0,
                  compute_dtype=args.compute_dtype,
                  deterministic=args.deterministic,
                  launches=capture["launches"])
    print("timing:", json.dumps(timing), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(_jsonable(runs), f, indent=2)
    print("checkpoint:", os.path.join(args.out, "exp", "model_last.npz"))
    if args.check is not None:
        failed = FLOORS[args.check](out)
        for name in failed:
            print(f"FLOOR FAILED ({args.check}-scene protocol): {name}",
                  flush=True)
        if failed:
            return 1
        print(f"all floors of the {args.check}-scene protocol hold",
              flush=True)
    return 0


def _jsonable(v):
    """Non-finite floats as None (json.dump would write Infinity)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


def _med(vals):
    fin = [v for v in vals if np.isfinite(v)]
    return np.median(fin) if fin else float("inf")


def _fmax(vals):
    fin = [v for v in vals if np.isfinite(v)]
    return max(fin) if len(fin) == len(vals) and fin else float("inf")


if __name__ == "__main__":
    raise SystemExit(main())
