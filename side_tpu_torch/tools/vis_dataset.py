"""Visual check of the target generator (port of tools/vis_dataset.py):
iterate the port's `StereoKitti`, rebuild each GT box, its keypoints and
its visible borders from the generated target tensors, map them back to
the original pixels through `transform_preds`, draw them on the image
(mirrored where the stereo-flip path swapped the views) and write PNGs.

    python -m side_tpu_torch.tools.vis_dataset stereo --data_dir data \\
        --exp_id vis

Writes `ds_<i>.png` for the first `VIS_N` (default 8) samples of the val
split under the debug directory (`<exp_dir>/<task>/<exp_id>/debug`).  Host
only; reads and draws with OpenCV (cv2).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..config import Config
from ..data import geometry as G
from ..data.dataset import StereoKitti
from ..utils.debugger import require_cv2


def draw_sample(cfg: Config, s: dict) -> np.ndarray:
    """One sample's targets drawn on its source image."""
    cv2 = require_cv2()
    meta = s["meta"]
    img = cv2.imread(meta["image_right"] if meta["flipped"]
                     else meta["image_path"])
    if meta["flipped"]:
        img = img[:, ::-1].copy()
    c, sc = meta["c"], meta["s"]
    out_size = (cfg.output_w, cfg.output_h)
    for j in range(int(s["rot_mask"].sum())):
        idx = s["ind"][j]
        ys, xs = idx // cfg.output_w, idx % cfg.output_w
        cx = xs + s["reg"][j, 0]
        cy = ys + s["reg"][j, 2]
        w, h = s["wh"][j, 0], s["wh"][j, 2]
        box = np.array([[cx - w / 2, cy - h / 2],
                        [cx + w / 2, cy + h / 2]])
        box = G.transform_preds(box, c, sc, out_size)
        cv2.rectangle(img, tuple(box[0].astype(int)),
                      tuple(box[1].astype(int)), (0, 255, 0), 2)
        # keypoints are box-relative u at output res
        x1_out = cx - w / 2
        for t in range(4):
            u_out = s["kept"][j, t] + x1_out
            pt = G.transform_preds(np.array([[u_out, cy]]), c, sc,
                                   out_size)[0]
            cv2.drawMarker(img, tuple(pt.astype(int)), (0, 0, 255),
                           cv2.MARKER_TILTED_CROSS, 10, 2)
        for t in (4, 5):  # visible borders
            u_out = s["kept"][j, t] + x1_out
            pt = G.transform_preds(np.array([[u_out, cy]]), c, sc,
                                   out_size)[0]
            cv2.line(img, (int(pt[0]), int(box[0, 1])),
                     (int(pt[0]), int(box[1, 1])), (255, 200, 0), 1)
    return img


def main(argv=None) -> int:
    cv2 = require_cv2()
    cfg = Config.cli(sys.argv[1:] if argv is None else argv)
    ds = StereoKitti(cfg, "val")
    os.makedirs(cfg.debug_dir, exist_ok=True)
    n = min(len(ds), int(os.environ.get("VIS_N", "8")))
    for i in range(n):
        s = ds[i]
        path = os.path.join(cfg.debug_dir, f"ds_{i:03d}.png")
        cv2.imwrite(path, draw_sample(cfg, s))
        print(f"wrote {path} ({int(s['rot_mask'].sum())} objects, "
              f"flipped={s['meta']['flipped']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
