"""Single stereo-pair demo of the port (mirrors tools/demo.py without the
overlay drawing).

    python -m side_tpu_torch.demo --demo left.png,right.png --calib calib.txt \
        [--load_model model.npz]

`--demo` may also name a KITTI-layout directory (image_2/, image_3/): every
pair in it is processed.  Runs on the GPU; add `--device cpu` to run the
plain CPU path.  Reading image files needs OpenCV (cv2).
"""

from __future__ import annotations

import os
import sys

from .config import Config
from .data.kitti import read_calib_file

STAGES = ("tot", "load", "pre", "net", "dec", "post", "merge")


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
    if cfg.debug:
        raise SystemExit(f"--debug {cfg.debug}: the overlay drawing of "
                         "tools/demo.py is not ported yet (ROADMAP.md, "
                         "Queue 1 item 4.7); run without --debug")
    if not cfg.demo:
        raise SystemExit("--demo left.png,right.png (or a KITTI dir) required")
    if not calib_path:
        raise SystemExit("--calib calib.txt required")
    calib = read_calib_file(calib_path)

    from .runtime.detector import Detector
    detector = Detector(cfg, device=device)

    if "," in cfg.demo:
        pairs = [tuple(cfg.demo.split(","))]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
