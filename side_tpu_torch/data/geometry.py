"""Host-side affine geometry (copy of the functions of
side_tpu/data/geometry.py that inference uses: the center/scale affine of
the pre-process and the point transform)."""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------- affine
def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv=False) -> np.ndarray:
    """2x3 affine mapping a (center, scale) crop box to `output_size`.

    Same geometry as image.py:27-60: the source box is an axis-aligned
    square-ish region of width scale[0] centered at `center` (optionally
    rotated by `rot` degrees), the destination is the output canvas.
    Returns the 2x3 matrix; `inv=True` returns the inverse mapping.
    """
    center = np.asarray(center, np.float64)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], np.float64)
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)

    src_w = float(scale[0])
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    # direction from center to a point half-a-width "up", rotated
    src_dir = np.array([0.0 * cs - (-0.5 * src_w) * sn,
                        0.0 * sn + (-0.5 * src_w) * cs])
    dst_dir = np.array([0.0, -0.5 * dst_w])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src

    # solve [x y 1] @ A.T = dst for the 2x3 matrix A
    ones = np.ones((3, 1))
    M = np.concatenate([src, ones], axis=1)  # 3x3
    A = np.linalg.solve(M, dst)              # 3x2
    return A.T.astype(np.float64)            # 2x3


def affine_transform(pt, t) -> np.ndarray:
    """Apply a 2x3 affine to one point (image.py:63-66)."""
    p = np.array([pt[0], pt[1], 1.0], np.float64)
    return (t @ p)[:2]
