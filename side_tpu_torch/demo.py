"""Stereo demo of the port (mirrors tools/demo.py).

    python -m side_tpu_torch.demo --demo left.png,right.png --calib calib.txt \
        [--load_model model.npz] [--debug 1]
    python -m side_tpu_torch.demo --demo left.mp4,right.mp4 --calib calib.txt

`--demo` may also name a KITTI-layout directory (image_2/, image_3/): every
pair in it is processed.  A pair of video files (mp4, mov, avi, mkv) is read
frame by frame in step, one `Detector.run` per frame, until the shorter
stream ends.  `--debug 1` (image pairs) draws the 3D boxes above
`--vis_thresh` on the left image and the bird's-eye view, saved as
`{index}_add_pred.png` and `{index}_bird.png` under the debug directory
(`<exp_dir>/<task>/<exp_id>/debug`).  Runs on the GPU; add `--device cpu`
to run the plain CPU path.  Reading image or video files and drawing need
OpenCV (cv2).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .config import CLASS_NAMES, Config
from .data.kitti import read_calib_file
from .utils.debugger import Debugger, require_cv2

STAGES = ("tot", "load", "pre", "net", "dec", "post", "merge")
VIDEO_EXT = ("mp4", "mov", "avi", "mkv")


def _pop_option(argv, name):
    if name not in argv:
        return argv, None
    i = argv.index(name)
    if i + 1 >= len(argv):
        raise SystemExit(f"{name} needs a value")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, calib_path = _pop_option(argv, "--calib")
    argv, device = _pop_option(argv, "--device")
    cfg = Config.cli(argv)
    if not cfg.demo:
        raise SystemExit("--demo left.png,right.png (or a KITTI dir) required")
    if not calib_path:
        raise SystemExit("--calib calib.txt required")
    calib = read_calib_file(calib_path)
    if cfg.debug >= 1:
        require_cv2()       # before the network is built

    from .runtime.detector import Detector
    detector = Detector(cfg, device=device)

    paths = cfg.demo.split(",")
    if len(paths) == 2 and all(is_video(p) for p in paths):
        return run_video(detector, paths, calib)

    if "," in cfg.demo:
        pairs = [tuple(paths)]
    else:
        left_dir = os.path.join(cfg.demo, "image_2")
        right_dir = os.path.join(cfg.demo, "image_3")
        pairs = [(os.path.join(left_dir, f), os.path.join(right_dir, f))
                 for f in sorted(os.listdir(left_dir))]

    for idx, (lp, rp) in enumerate(pairs):
        ret = detector.run([lp, rp], image_id=idx, calib=calib)
        print(f"{os.path.basename(lp)}: " + "".join(
            f"{stage} {ret[stage]:.3f}s |" for stage in STAGES))
        n = sum(len(v) for v in ret["results"].values())
        print(f"  {n} detections above peak_thresh={cfg.peak_thresh}")
        if cfg.debug >= 1:
            draw_overlays(cfg, lp, ret["results"], calib, idx)
            print(f"  overlays saved to {cfg.debug_dir}")
    return 0


def is_video(path: str) -> bool:
    return path.rsplit(".", 1)[-1].lower() in VIDEO_EXT


def run_video(detector, paths, calib) -> int:
    """The stereo video branch of tools/demo.py: a synchronised left, right
    file pair, one `Detector.run` per frame pair, until either stream
    ends."""
    cv2 = require_cv2()
    caps = [cv2.VideoCapture(p) for p in paths]
    try:
        idx = 0
        while True:
            (ok_l, img_l), (ok_r, img_r) = (c.read() for c in caps)
            if not (ok_l and ok_r):
                break
            ret = detector.run([img_l, img_r], image_id=idx, calib=calib)
            print(f"frame {idx}: " + "".join(
                f"{stage} {ret[stage]:.3f}s |" for stage in STAGES),
                flush=True)
            idx += 1
    finally:
        for c in caps:
            c.release()
    return 0


def draw_overlays(cfg: Config, left_path: str, results, calib,
                  idx: int) -> None:
    """tools/demo.py's `--debug 1` drawing: 3D boxes on the left image and
    the bird's-eye view, saved as `{idx}_*.png` under `cfg.debug_dir`."""
    dbg = Debugger(class_names=CLASS_NAMES[1:])
    dbg.add_3d_detection(dbg.cv2.imread(left_path), results,
                         np.asarray(calib[2]), center_thresh=cfg.vis_thresh)
    dbg.add_bird_view(results, center_thresh=cfg.vis_thresh)
    os.makedirs(cfg.debug_dir, exist_ok=True)
    dbg.save_all_imgs(cfg.debug_dir, prefix=f"{idx}_")


if __name__ == "__main__":
    sys.exit(main())
