"""Offline KITTI -> COCO-format JSON converter over the port's
`data/kitti.py:convert_split` (port of tools/convert_kitti_to_coco.py).

    python -m side_tpu_torch.tools.convert_kitti_to_coco \\
        --data_dir data/kitti --splits 3dop,subcnn

Writes `annotations_3d/kitti_<split>_{train,val}.json` under `--data_dir`.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..data.kitti import convert_split


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m side_tpu_torch.tools.convert_kitti_to_coco")
    p.add_argument("--data_dir", default="data/kitti")
    p.add_argument("--splits", default="3dop,subcnn")
    a = p.parse_args(argv)
    for split_name in a.splits.split(","):
        for split in ("train", "val"):
            out = os.path.join(a.data_dir, "annotations_3d",
                               f"kitti_{split_name}_{split}.json")
            d = convert_split(a.data_dir, split_name, split, out)
            print(f"{out}: {len(d['images'])} images, "
                  f"{len(d['annotations'])} annotations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
