"""KITTI calibration (copy of Calib, calib_from_list and read_calib_file
of side_tpu/data/kitti.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Calib:
    """Full-frame calibration: P0..P3 3x4 projections (stereo_utils.py:33-43)."""
    p0: np.ndarray = None
    p1: np.ndarray = None
    p2: np.ndarray = None
    p3: np.ndarray = None

    @property
    def f(self) -> float:
        return float(self.p2[0, 0])

    @property
    def baseline(self) -> float:
        """Stereo baseline in metres (stereoDataset.py:277-278)."""
        return float((self.p2[0, 3] - self.p3[0, 3]) / self.f)

    @property
    def fb(self) -> float:
        return self.f * self.baseline


def calib_from_list(calib_list: Sequence) -> Calib:
    """Build a Calib from the per-image COCO-JSON calib (list of 4+ 3x4s)."""
    ps = [np.asarray(calib_list[i], np.float64).reshape(3, 4) for i in range(4)]
    return Calib(p0=ps[0], p1=ps[1], p2=ps[2], p3=ps[3])


def read_calib_file(path: str) -> List[List[float]]:
    """Parse a raw KITTI calib txt into the list-of-rows format stored in the
    COCO JSON (convert_kitti_to_coco.py:43-55)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            vals = np.array(line.split(" ")[1:], np.float32)
            vals = vals.reshape(3, 3) if i == 4 else vals.reshape(3, 4)
            out.append(vals.tolist())
    return out
